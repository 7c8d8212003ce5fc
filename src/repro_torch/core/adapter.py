"""The DSDE SL Adapter math (paper §3.1; ``repro.core.adapter``).

Per sequence and iteration: Eq. (1) calibration of SL_max, Eq. (3) the
scale factor, Eq. (4) WVIR (``signals``), Eq. (2)/(8) the predicted SL
with its conservative floor, Eq. (11) SL_cap, the static baseline and
AdaEDL's entropy stop bound.
The math is unchanged; the state is a NamedTuple of tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.config import SpecDecodeConfig
from repro_torch.core.signals import KLDHistory, wvir


class AdapterState(NamedTuple):
    history: KLDHistory
    mu_kld_last: torch.Tensor       # [B] mean KLD of the last verified step
    sl_max: torch.Tensor            # [B] calibrated effective max (Eq. 1)
    calib_steps: torch.Tensor       # [B] steps observed so far
    calib_kld_sum: torch.Tensor     # [B] sum of token KLDs
    calib_kld_count: torch.Tensor   # [B] token count
    calib_kld_max: torch.Tensor     # [B] max single KLD
    calib_acc_max: torch.Tensor     # [B] SL_{A,max}: max accepted in a step
    sl_pred: torch.Tensor           # [B] int32 last predicted SL


def init_adapter_state(batch: int, cfg: SpecDecodeConfig,
                       device="cpu") -> AdapterState:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return AdapterState(
        history=KLDHistory.init(batch, cfg.long_window, device),
        mu_kld_last=torch.zeros((batch,), **f32),
        sl_max=torch.full((batch,), float(cfg.sl_max), **f32),
        calib_steps=torch.zeros((batch,), **i32),
        calib_kld_sum=torch.zeros((batch,), **f32),
        calib_kld_count=torch.zeros((batch,), **f32),
        calib_kld_max=torch.zeros((batch,), **f32),
        calib_acc_max=torch.zeros((batch,), **i32),
        sl_pred=torch.full((batch,), cfg.static_sl, **i32))


def observe(state: AdapterState, cfg: SpecDecodeConfig, *,
            kld: torch.Tensor, proposed_valid: torch.Tensor,
            num_accepted: torch.Tensor,
            active: Optional[torch.Tensor] = None) -> AdapterState:
    """Fold one verification step's post-hoc statistics into the state."""
    if kld.shape[-1] == 0:      # nothing proposed
        return state
    v = proposed_valid.float()
    tok_count = v.sum(-1)
    step_sum = (kld * v).sum(-1)
    mu_step = step_sum / tok_count.clamp(min=1.0)
    step_max = torch.where(proposed_valid, kld, -torch.inf).amax(-1)
    step_max = torch.where(torch.isfinite(step_max), step_max, 0.0)

    in_calib = state.calib_steps < cfg.calibration_steps
    took_step = tok_count > 0
    if active is not None:
        took_step = took_step & active
    upd = took_step & in_calib
    calib_steps = torch.where(upd, state.calib_steps + 1, state.calib_steps)
    calib_kld_sum = torch.where(upd, state.calib_kld_sum + step_sum,
                                state.calib_kld_sum)
    calib_kld_count = torch.where(upd, state.calib_kld_count + tok_count,
                                  state.calib_kld_count)
    calib_kld_max = torch.where(upd, torch.maximum(state.calib_kld_max,
                                                   step_max),
                                state.calib_kld_max)
    calib_acc_max = torch.where(
        upd, torch.maximum(state.calib_acc_max, num_accepted.to(torch.int32)),
        state.calib_acc_max)

    # Eq. (1): once the calibration window closes, freeze SL_max
    done = calib_steps >= cfg.calibration_steps
    mu_pre = calib_kld_sum / calib_kld_count.clamp(min=1.0)
    sl_a_max = calib_acc_max.clamp(min=1).float()
    sl_max_calib = sl_a_max * (1.0 + mu_pre / (calib_kld_max + cfg.eps))
    sl_max_calib = sl_max_calib.clamp(cfg.sl_min + 1, cfg.sl_max)
    sl_max = torch.where(done, sl_max_calib, state.sl_max)

    return state._replace(
        history=state.history.push(mu_step, active=took_step),
        mu_kld_last=torch.where(took_step, mu_step, state.mu_kld_last),
        sl_max=sl_max, calib_steps=calib_steps.to(torch.int32),
        calib_kld_sum=calib_kld_sum, calib_kld_count=calib_kld_count,
        calib_kld_max=calib_kld_max,
        calib_acc_max=calib_acc_max.to(torch.int32))


def scale_factor(mu_kld_last: torch.Tensor, cfg: SpecDecodeConfig,
                 mu_calib: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (3); optionally the scale-invariant variant (sf_normalize)."""
    if cfg.sf_normalize and mu_calib is not None:
        rel = mu_kld_last / mu_calib.clamp(min=cfg.eps) - 1.0
        return (torch.exp(cfg.sf_scale * rel) - 1.0).clamp(min=0.0)
    return torch.exp(cfg.sf_scale * mu_kld_last) - 1.0


def apply_sl_cap(sl: torch.Tensor, cfg: SpecDecodeConfig,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (9)-(11): cap = mean of the active rows' SL, applied to all."""
    if active is None:
        cap = sl.mean()
    else:
        a = active.float()
        cap = (sl * a).sum() / a.sum().clamp(min=1.0)
    return torch.minimum(sl, cap), cap


def predict_sl(state: AdapterState, cfg: SpecDecodeConfig,
               active: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, AdapterState, dict]:
    """Per-sequence SL for the next iteration: (sl [B] int32, new_state,
    telemetry)."""
    mu_calib = state.calib_kld_sum / state.calib_kld_count.clamp(min=1.0)
    sf = scale_factor(state.mu_kld_last, cfg, mu_calib)
    w = wvir(state.history, cfg.short_window, cfg.long_window, cfg.decay,
             cfg.eps)
    penalty = sf * w
    raw = (1.0 - penalty) * (state.sl_max - float(cfg.sl_min)) + cfg.sl_min
    sl = torch.where(penalty >= cfg.penalty_cutoff,
                     torch.full_like(raw, float(cfg.sl_min)), raw)  # Eq. (8)
    in_calib = state.calib_steps < cfg.calibration_steps
    sl = torch.where(in_calib, torch.full_like(sl, float(cfg.calibration_sl)),
                     sl)
    telemetry = {"sf": sf, "wvir": w, "penalty": penalty, "sl_raw": raw,
                 "sl_max": state.sl_max}
    if cfg.use_sl_cap:
        sl, cap = apply_sl_cap(sl, cfg, active)
        telemetry["sl_cap"] = cap
    sl_i = torch.round(sl).clamp(cfg.sl_min, cfg.sl_max).to(torch.int32)
    return sl_i, state._replace(sl_pred=sl_i), telemetry


def static_sl(batch: int, cfg: SpecDecodeConfig, device="cpu") -> torch.Tensor:
    return torch.full((batch,), cfg.static_sl, dtype=torch.int32,
                      device=device)


def adaedl_stop_threshold(entropy: torch.Tensor,
                          cfg: SpecDecodeConfig) -> torch.Tensor:
    """AdaEDL: keep drafting while the entropy-based lower bound on the
    token acceptance probability,
    ``1 - sqrt(max(0, 1 - exp(-H(q))))``, stays at or above the
    threshold.  Returns the bool 'keep drafting' mask."""
    bound = 1.0 - torch.sqrt((1.0 - torch.exp(-entropy)).clamp(min=0.0))
    return bound >= cfg.adaedl_threshold
