"""The paper pipeline's workloads: a copy of the reference's
``benchmarks/common.py`` for the port (the port imports nothing of the
JAX package or of ``benchmarks``).

Draft/target pairs are *trained* (not random) so acceptance dynamics are
real (DESIGN.md §3).  Two pairs mirror the paper's §4.1/§4.4 regimes:

* ``llama`` pair: strong draft (same data, 60% of the target's
  training), the high-acceptance regime (paper's LLaMA-70B /
  LLaMA-3.2-1B).
* ``gemma`` pair: weak, divergent draft (narrower, fewer steps, partly
  disjoint data), the low-acceptance regime (paper's Gemma-27B /
  Gemma-2B, k_opt = 2).

Synthetic datasets emulate the paper's eight-task heterogeneity through
Markov-chain peakedness (predictability): code > qa > news > dialogue.
The same names and seeds give the reference's tokens byte for byte.

Latency reporting: wall-clock is machine-bound, so the cross-policy
metric is the hardware-neutral cost model
    latency_units = rounds * C_target + draft_steps * C_draft
with C_draft/C_target the pair's cost ratio.

Trained pairs are cached as checkpoints in the reference's format under
``CACHE_DIR`` (``$REPRO_TORCH_BENCH_CACHE``, default
``repro_torch_bench_cache`` in the temporary directory): a directory of
its own, so a checkpoint of the JAX package is never taken for one of
the port's.  Every entry point runs on the card unless given
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.config import (ModelConfig, OptimizerConfig,
                                     ServingConfig, SpecDecodeConfig,
                                     TrainConfig)
from repro_torch.core.drafters import build_drafter
from repro_torch.models.weights import Params, init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import MarkovTaskCorpus, lm_batches
from repro_torch.training.train import train_loop

CACHE_DIR = os.environ.get(
    "REPRO_TORCH_BENCH_CACHE",
    os.path.join(tempfile.gettempdir(), "repro_torch_bench_cache"))
VOCAB = 512

DATASETS: Dict[str, float] = {   # name -> Markov peakedness
    "code": 3.0,       # HumanEval-like: highly predictable
    "qa": 1.5,         # GSM8K/HotpotQA-like
    "news": 0.8,       # CNNDM/XSum-like
    "dialogue": 0.35,  # ShareGPT-like: high entropy
}

Pair = Tuple[ModelConfig, ModelConfig, Params, Params, float]


def dataset(name: str) -> MarkovTaskCorpus:
    # crc32, NOT hash(): python randomizes hash() per process, which would
    # give the training and serving processes different corpora
    return MarkovTaskCorpus(VOCAB, peakedness=DATASETS[name],
                            seed=zlib.crc32(name.encode()) % 1000)


def mixed_stream(total_per: int = 150000) -> np.ndarray:
    return np.concatenate([dataset(n).stream(total_per, seed=i)
                           for i, n in enumerate(DATASETS)])


def target_config() -> ModelConfig:
    return get_config("smollm-135m").reduced()


def draft_config(weak: bool = False) -> ModelConfig:
    cfg = target_config()
    if weak:
        return dataclasses.replace(cfg, d_model=64, num_heads=2,
                                   num_kv_heads=1, head_dim=32, d_ff=128,
                                   name="draft-weak")
    return dataclasses.replace(cfg, d_model=128, num_heads=2,
                               num_kv_heads=1, head_dim=64, d_ff=256,
                               name="draft")


def train_model(cfg: ModelConfig, stream: np.ndarray, steps: int,
                seed: int = 0, device="cuda") -> Tuple[Params, Dict]:
    """The pairs' training recipe: batch 16 x 64 of ``stream``, AdamW at
    lr 3e-3 with 30 warm-up steps over ``steps``, gradients clipped at
    5.0, from the port's seeded init.  Returns ``train_loop``'s (params,
    metrics)."""
    tc = TrainConfig(global_batch_size=16, seq_len=64,
                     optimizer=OptimizerConfig(learning_rate=3e-3,
                                               warmup_steps=30,
                                               total_steps=steps,
                                               grad_clip=5.0))
    return train_loop(cfg, tc, lm_batches(stream, 16, 64, seed=seed),
                      num_steps=steps, verbose=False, seed=seed,
                      device=device)


def _train_cached(tag: str, cfg: ModelConfig,
                  stream: Callable[[], np.ndarray], steps: int,
                  seed: int = 0, device="cuda") -> Params:
    """``CACHE_DIR/tag``'s checkpoint if it fits ``cfg``, else
    :func:`train_model` on ``stream()`` (made only then), saved there."""
    path = os.path.join(CACHE_DIR, tag)
    ck = latest_checkpoint(path)
    template = init_params(cfg, seed=seed, device=device)
    if ck:
        try:
            params, _ = restore_checkpoint(ck, template)
            return params
        except (KeyError, ValueError):
            pass   # stale cache from an older architecture revision
    params, m = train_model(cfg, stream(), steps, seed, device)
    print(f"  [pair] trained {tag}: steps={steps} loss={m['loss']:.3f}")
    save_checkpoint(path, steps, params)
    return params


def untrained_pair(device="cuda") -> Pair:
    """Seeded random target/draft pair for smoke lanes: acceptance
    dynamics are noise, but schedule/exactness behaviour is unchanged
    and there is no training.  Same return shape as :func:`build_pair`."""
    cfg_t, cfg_d = target_config(), draft_config()
    pt = init_params(cfg_t, seed=1, device=device)
    pd = init_params(cfg_d, seed=2, device=device)
    return cfg_t, cfg_d, pt, pd, 0.1


def build_pair(regime: str = "llama", device="cuda") -> Pair:
    """Returns (cfg_t, cfg_d, params_t, params_d, cost_ratio)."""
    if regime not in ("llama", "gemma"):
        raise ValueError(regime)
    os.makedirs(CACHE_DIR, exist_ok=True)
    cfg_t = target_config()
    stream = functools.cache(mixed_stream)
    pt = _train_cached("target", cfg_t, stream, steps=1600, device=device)
    if regime == "llama":
        cfg_d = draft_config(weak=False)
        pd = _train_cached("draft_llama", cfg_d, stream, steps=1000, seed=5,
                           device=device)
    else:
        cfg_d = draft_config(weak=True)

        def half():
            # divergent training distribution: only half the tasks
            return np.concatenate([dataset("code").stream(100000, seed=9),
                                   dataset("news").stream(100000, seed=10)])
        pd = _train_cached("draft_gemma", cfg_d, half, steps=180, seed=9,
                           device=device)
    # cost ratio for the latency model: emulate the PAPER's deployments
    # (LLaMA-3.2-1B/LLaMA-3.1-70B ~ 0.014; Gemma-2B/27B ~ 0.074).  The
    # miniatures are embedding-dominated, so their parameter ratio (~0.3)
    # wildly overstates what a real draft costs.
    ratio = 0.014 if regime == "llama" else 0.074
    return cfg_t, cfg_d, pt, pd, ratio


def serve(cfg_t, cfg_d, pt, pd, prompts: List[List[int]], *,
          policy: str = "dsde", temperature: float = 0.0,
          max_new: int = 48, batch: int = 8, use_cap: bool = True,
          static_sl: int = 4, sl_max: int = 10, adaedl_base: int = 7,
          adaedl_threshold: float = 0.02, seed: int = 0,
          max_seq_len: int = 512,
          goodput_draft_cost: Optional[float] = None,
          max_new_per_req: Optional[List[int]] = None,
          paged: bool = False, kv_block_size: int = 16,
          num_kv_blocks: Optional[int] = None,
          prefix_caching: bool = False,
          pipelined: bool = False, drafter: str = "model",
          kv_quant: str = "none", device="cuda"
          ) -> Tuple[Dict, List[Request], ServingEngine]:
    """Serve ``prompts`` to the end on one engine; returns (run summary,
    requests, engine).  A model-free drafter serves with no draft
    params."""
    extra = {}
    if goodput_draft_cost is not None:
        # the goodput controller's cost model should use the same pair
        # cost ratio the latency_units report uses (None = sourced from
        # the drafter's own step_cost())
        extra["goodput_draft_cost"] = goodput_draft_cost
    spec = SpecDecodeConfig(policy=policy, drafter=drafter,
                            temperature=temperature,
                            use_sl_cap=use_cap, static_sl=static_sl,
                            sl_max=sl_max, adaedl_base=adaedl_base,
                            adaedl_threshold=adaedl_threshold,
                            # miniature-regime KLD scales (DESIGN.md §3):
                            # scale-invariant SF keeps Eq. 2's dynamic range
                            sf_normalize=True, **extra)
    if not build_drafter(spec, cfg_t, cfg_d).uses_draft_model():
        pd, cfg_d = None, None   # model-free proposer: no draft params
    eng = ServingEngine(pt, cfg_t, pd, cfg_d, spec,
                        ServingConfig(max_batch_size=batch,
                                      max_seq_len=max_seq_len,
                                      paged_kv=paged,
                                      kv_block_size=kv_block_size,
                                      num_kv_blocks=num_kv_blocks,
                                      prefix_caching=prefix_caching,
                                      pipelined=pipelined,
                                      kv_quant=kv_quant),
                        seed=seed, device=device)
    reqs = [Request(i, prompt=p,
                    max_new_tokens=(max_new_per_req[i]
                                    if max_new_per_req is not None
                                    else max_new))
            for i, p in enumerate(prompts)]
    metrics = eng.run(reqs)
    return metrics, reqs, eng


def dist_stats(values, prefix: str,
               ps: Tuple[int, ...] = (50, 99)) -> Dict[str, float]:
    """Mean + percentile summary of a latency/size distribution, keyed
    ``{prefix}_mean`` / ``{prefix}_p{P}``.  Empty-safe (all-zero) and
    None-filtering, so callers can pass raw per-request metric lists
    (``[r.ttft() for r in reqs]``) without pre-cleaning; ``np.percentile``
    with linear interpolation, as every table of the reference."""
    vals = [v for v in values if v is not None]
    out = {f"{prefix}_mean": float(np.mean(vals)) if vals else 0.0}
    for p in ps:
        out[f"{prefix}_p{p}"] = (float(np.percentile(vals, p))
                                 if vals else 0.0)
    return out


def latency_units(metrics: Dict, cost_ratio: float) -> float:
    """Hardware-neutral serving cost: target rounds + draft-step cost.
    Uses *effective* draft steps (early-stopping policies like AdaEDL skip
    the remaining steps on dynamic-shape runtimes)."""
    steps = metrics.get("draft_steps_effective", metrics["draft_steps"])
    return metrics["rounds"] + steps * cost_ratio


def static_opt(cfg_t, cfg_d, pt, pd, prompts, ratio, temperature,
               device="cuda"):
    """The static-optimum baseline as the paper obtains it (the
    reference's ``benchmarks/table3_latency_speedup.static_opt``):
    serve at SL 2, 4, 6, 8 and 10 and keep the cheapest in latency
    units; returns (sl, latency_units, summary)."""
    best = None
    for sl in (2, 4, 6, 8, 10):
        m, _, _ = serve(cfg_t, cfg_d, pt, pd, prompts, policy="static",
                        static_sl=sl, temperature=temperature, device=device)
        lu = latency_units(m, ratio)
        if best is None or lu < best[1]:
            best = (sl, lu, m)
    return best
