"""Interpretable analytic per-round latency model (a copy of
``repro.serving.latency_model``; DESIGN.md §15).

The wall cost of one speculative round is fitted from schedule-visible
quantities by recursive least squares with a forgetting factor:

    T_round  ≈  c0  +  c_prefill · tokens  +  c_draft · K
                    +  c_verify · (K + 1) · B_eff

``tokens`` is the prefill tokens that rode the round, ``K`` the draft
bucket, ``B_eff`` the live rows verified.  The engine feeds it one
sample per collected round and reports the coefficients in its summary
(``latency_model_*``) and the pre-update prediction per round
(``t_round_pred_s``).  A calibration sweep's round log warm-starts the
fit (:meth:`RoundLatencyModel.warm_start_from_rounds`).  Its consumers
are the ``slo`` policy (``predict_round_s`` against the batch's tightest
deadline) and the scheduler's SLO admission gate (best-case completion
of a queued request); both act only once :meth:`ready` holds.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np

# feature order, fixed: [1, tokens, K, (K+1)*B_eff]
COEF_NAMES = ("c0", "c_prefill", "c_draft", "c_verify")
N_COEF = 4


def round_features(k: int, b_eff: int,
                   prefill_tokens: float = 0.0) -> np.ndarray:
    """The model's regressor vector for one round."""
    return np.array(
        [1.0, float(prefill_tokens), float(k), float(k + 1) * float(b_eff)],
        np.float64)


class RoundLatencyModel:
    """RLS fit of the four-term per-round latency form.

    ``forgetting`` < 1 geometrically down-weights old rounds so the
    model tracks drifting host conditions; ``prior_scale`` sets the
    initial parameter covariance (large = the first samples dominate
    the zero prior quickly); ``min_rounds`` is the readiness gate: below
    it :meth:`ready` is False and the SLO consumers stay deadline-blind.
    """

    def __init__(self, forgetting: float = 0.995,
                 prior_scale: float = 1e4, min_rounds: int = 8):
        assert 0.0 < forgetting <= 1.0
        self.forgetting = float(forgetting)
        self.min_rounds = int(min_rounds)
        self.theta = np.zeros((N_COEF,), np.float64)
        self.P = np.eye(N_COEF, dtype=np.float64) * float(prior_scale)
        self.rounds_fit = 0
        # EMA of squared prediction error (pre-update residual), for the
        # summary's honesty field: how well the form actually fits
        self._mse_ema = 0.0

    # ------------------------------------------------------------------ fit
    def observe(self, wall_s: float, k: int, b_eff: int,
                prefill_tokens: float = 0.0) -> float:
        """Fold one measured round in; returns the pre-update residual
        (prediction error the model made on this round)."""
        phi = round_features(k, b_eff, prefill_tokens)
        err = float(wall_s) - float(self.theta @ phi)
        lam = self.forgetting
        Pphi = self.P @ phi
        gain = Pphi / (lam + float(phi @ Pphi))
        self.theta = self.theta + gain * err
        self.P = (self.P - np.outer(gain, Pphi)) / lam
        self.rounds_fit += 1
        a = 0.9 if self.rounds_fit > 1 else 0.0
        self._mse_ema = a * self._mse_ema + (1.0 - a) * err * err
        return err

    def warm_start_from_rounds(self, round_log: Iterable[Dict]) -> int:
        """Seed the fit from a calibration sweep: a batch ridge least
        squares over an engine ``round_log`` (entries with ``wall_s`` /
        ``k`` / ``b_eff`` / ``prefill_tokens``).  Returns the rounds
        absorbed; entries without ``wall_s`` or ``k`` are skipped.  The
        batch's information becomes the RLS prior (P = gram^-1), so later
        online samples update from the calibration."""
        X: List[np.ndarray] = []
        y: List[float] = []
        for rec in round_log:
            if "wall_s" not in rec or "k" not in rec:
                continue
            X.append(round_features(int(rec["k"]),
                                    int(rec.get("b_eff", 1)),
                                    float(rec.get("prefill_tokens", 0.0))))
            y.append(float(rec["wall_s"]))
        if not X:
            return 0
        Xm = np.stack(X)
        yv = np.asarray(y, np.float64)
        gram = Xm.T @ Xm + 1e-8 * np.eye(N_COEF)
        self.theta = np.linalg.solve(gram, Xm.T @ yv)
        self.P = np.linalg.inv(gram)
        self.rounds_fit += len(y)
        resid = yv - Xm @ self.theta
        self._mse_ema = float(np.mean(resid * resid))
        return len(y)

    # -------------------------------------------------------------- predict
    def ready(self) -> bool:
        return self.rounds_fit >= self.min_rounds

    def predict_round_s(self, k: int, b_eff: int,
                        prefill_tokens: float = 0.0) -> float:
        """Predicted wall seconds of one round at bucket ``k`` with
        ``b_eff`` live rows (clamped at 0: a noisy fit never predicts
        a negative cost)."""
        return max(float(self.theta @ round_features(k, b_eff,
                                                     prefill_tokens)), 0.0)

    def predict_prefill_s(self, tokens: int) -> float:
        """Predicted cost of prefilling ``tokens``: the c0 + c_prefill
        slice of the form (what an admission wave adds to its round)."""
        return max(float(self.theta[0] + self.theta[1] * float(tokens)), 0.0)

    # ------------------------------------------------------------ telemetry
    def coefficients(self) -> Dict[str, float]:
        return {name: float(v) for name, v in zip(COEF_NAMES, self.theta)}

    def rmse_s(self) -> float:
        return float(np.sqrt(max(self._mse_ema, 0.0)))

    def summary_fields(self) -> Dict[str, float]:
        """The run-summary view: prefixed coefficient fields plus fit
        telemetry, merged into ``ServingEngine.summary()``."""
        out = {f"latency_model_{k}": v for k, v in self.coefficients().items()}
        out["latency_model_rounds_fit"] = float(self.rounds_fit)
        out["latency_model_rmse_s"] = self.rmse_s()
        return out
