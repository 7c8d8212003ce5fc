"""Sampled (temperature 1.0) streams of the port are distributed exactly
as target-only autoregressive sampling: a chi-square test of the engine's
two-token joint over a tiny vocabulary, many identical requests with
distinct seeds, against the analytic target joint (the reference's
``tests/test_drafters.py`` and ``tests/test_kv_quant.py`` harness).  Cases:
the model, n-gram and self drafters on the dense ring, the model and
n-gram drafters on the int8 pool (against the quantized cache's joint),
and an SSM target with its model drafter (whose commit is the masked
re-advance).  Each case also checks that its counts do NOT fit the
uniform joint, so the test has teeth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import ModelConfig, SSMConfig
from repro.models.module import init_params
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro_torch.core import prefill as t_prefill
from repro_torch.core.config import ModelConfig as TModel
from repro_torch.core.config import SSMConfig as TSSM
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.models import cache as t_cache
from repro_torch.models.transformer import forward
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")
V = 8
N = 2400
PROMPT = [1, 2, 3, 1, 2, 3, 1, 2]     # repetitive: the n-gram drafter proposes


def _cfgs(family):
    """(reference config, port config) of the tiny target."""
    kw = dict(name=f"stat-tiny-{family}", family=family, num_layers=2,
              d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
              vocab_size=V, head_dim=16)
    if family == "ssm":
        kw.update(num_heads=1, num_kv_heads=1, d_ff=0)
        return (ModelConfig(**kw, ssm=SSMConfig(state_size=8, head_dim=16,
                                                chunk_size=8)),
                TModel(**kw, ssm=TSSM(state_size=8, head_dim=16,
                                      chunk_size=8)))
    return ModelConfig(**kw), TModel(**kw)


def _params(cfg):
    """(target, draft) as the port's tensors: the reference's init with
    the tied embedding x 5 (a random tiny model is near uniform over 8
    tokens, which would leave the test without teeth), the draft the
    target plus 0.1 x noise."""
    pt = dict(init_params(model_specs(cfg), jax.random.PRNGKey(5),
                          jnp.float32))
    pt["embed"] = pt["embed"] * 5.0
    noise = init_params(model_specs(cfg), jax.random.PRNGKey(6), jnp.float32)
    pd = jax.tree_util.tree_map(lambda a, b: a + 0.1 * b, pt, noise)
    conv = lambda t: from_reference(jax.tree_util.tree_map(np.asarray, t),  # noqa: E731
                                    device="cpu")
    return pt, conv(pt), conv(pd)


def _joint(tpt, tcfg):
    """P(t1, t2 | prompt) of target-only sampling, from the port's train
    forward."""
    toks = torch.tensor([PROMPT + [t1] for t1 in range(V)], dtype=torch.int32)
    lg, _ = forward(tpt, tcfg, toks, mode="train")
    p1 = torch.softmax(lg[0, -2, :V], -1)
    p2 = torch.softmax(lg[:, -1, :V], -1)
    return (p1[:, None] * p2).double().numpy()


def _joint_quant(tpt, tcfg, bs=16):
    """The same joint THROUGH the int8 pool: the prefill the engine runs,
    row 0 over the bare prompt, rows 1..V over ``prompt + [t1]`` (the
    prefill attends over the fake-quantized K/V that every later read of
    the stored pool sees)."""
    rows, big = 1 + V, len(PROMPT) + 1
    maxb = -(-big // bs)
    c = t_cache.paged_cache_struct(tcfg, rows, maxb * bs, rows * maxb, bs,
                                   kv_quant="int8")
    table = torch.arange(rows * maxb, dtype=torch.int32).reshape(rows, maxb)
    toks = torch.zeros((rows, big), dtype=torch.int32)
    lens = torch.full((rows,), big, dtype=torch.int32)
    toks[0, :len(PROMPT)] = torch.tensor(PROMPT)
    lens[0] = len(PROMPT)
    for t1 in range(V):
        toks[1 + t1] = torch.tensor(PROMPT + [t1])
    _, last = t_prefill.prefill_paged_rows(
        tpt, tcfg, c["k"], c["v"], c["kv_pos"], table, toks, lens,
        c["k_scale"], c["v_scale"])
    p1 = torch.softmax(last[0, :V], -1)
    p2 = torch.softmax(last[1:, :V], -1)
    joint = (p1[:, None] * p2).double().numpy()
    return joint / joint.sum()


def _chi2(counts: np.ndarray, probs: np.ndarray, n: int):
    """Pearson chi-square with small expected cells pooled (Cochran)."""
    exp = probs.reshape(-1) * n
    obs = counts.reshape(-1)
    big = exp >= 5.0
    chi = float((((obs[big] - exp[big]) ** 2) / exp[big]).sum())
    if (~big).any():
        eo, ee = obs[~big].sum(), exp[~big].sum()
        if ee > 0:
            chi += float((eo - ee) ** 2 / ee)
    df = int(big.sum()) + (1 if (~big).any() else 0) - 1
    return chi, df


CASES = {
    # name: (family, drafter, kv_quant)
    "model": ("dense", "model", "none"),
    "ngram": ("dense", "ngram", "none"),
    "self": ("dense", "self", "none"),
    "int8-model": ("dense", "model", "int8"),
    "int8-ngram": ("dense", "ngram", "int8"),
    "ssm-model": ("ssm", "model", "none"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampled_streams_statistically_exact(case):
    """Temperature-1.0 engine output (prefill sampling + the full
    propose / verify / reject / commit round, static SL 3) against the
    target's analytic joint: chi-square below ~5 sigma over the null
    mean, and far above it against the uniform joint.  The port's fp
    joint equals the reference model's to 1e-5."""
    family, drafter, quant = CASES[case]
    cfg, tcfg = _cfgs(family)
    pt, tpt, tpd = _params(cfg)
    if quant == "int8":
        joint = _joint_quant(tpt, tcfg)
    else:
        joint = _joint(tpt, tcfg)
        lg, _, _ = ref_forward(pt, cfg, jnp.asarray([PROMPT + [0]]),
                               mode="train")
        np.testing.assert_allclose(
            np.asarray(jax.nn.softmax(lg[0, -2, :V])), joint.sum(1),
            atol=1e-5)
    spec = TSpec(policy="static", static_sl=3, temperature=1.0,
                 drafter=drafter, self_draft_layers=1)
    model = drafter == "model"
    eng = TEngine(tpt, tcfg, tpd if model else None, tcfg if model else None,
                  spec, TServing(max_batch_size=32, max_seq_len=64,
                                 paged_kv=quant == "int8", kv_block_size=16,
                                 kv_quant=quant),
                  seed=0, device="cpu")
    reqs = [TRequest(i, prompt=list(PROMPT), max_new_tokens=2)
            for i in range(N)]
    m = eng.run(reqs)
    assert m["requests_finished"] == N
    assert sum(r["proposed"] for r in eng.round_log) > 0
    counts = np.zeros((V, V))
    for r in reqs:
        assert len(r.output) == 2
        counts[r.output[0], r.output[1]] += 1
    chi, df = _chi2(counts, joint, N)
    # ~5 sigma above the null mean: fails loudly for a biased sampler,
    # essentially never for an exact one at this fixed seed
    crit = df + 5.0 * np.sqrt(2.0 * df)
    assert chi < crit, (case, chi, df, crit)
    chi_u, df_u = _chi2(counts, np.full((V, V), 1.0 / V ** 2), N)
    assert chi_u > df_u + 5.0 * np.sqrt(2.0 * df_u), "test has no teeth"


def test_biased_sampler_fails_the_harness():
    """The harness rejects a sampler that is slightly off: the counts of
    the model-drafter case against the joint of a target whose embedding
    is scaled by 6.5 instead of 5 (a sharper distribution)."""
    cfg, tcfg = _cfgs("dense")
    pt, tpt, tpd = _params(cfg)
    spec = TSpec(policy="static", static_sl=3, temperature=1.0)
    eng = TEngine(tpt, tcfg, tpd, tcfg, spec,
                  TServing(max_batch_size=32, max_seq_len=64), seed=0,
                  device="cpu")
    reqs = [TRequest(i, prompt=list(PROMPT), max_new_tokens=2)
            for i in range(N)]
    eng.run(reqs)
    counts = np.zeros((V, V))
    for r in reqs:
        counts[r.output[0], r.output[1]] += 1
    tempered = dict(tpt, embed=tpt["embed"] * 1.3)
    chi, df = _chi2(counts, _joint(tempered, tcfg), N)
    assert chi > df + 5.0 * np.sqrt(2.0 * df)
