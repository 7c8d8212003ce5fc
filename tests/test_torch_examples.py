"""The port's five examples (``repro_torch.examples``) run end to end on
the CPU (``--device cpu``): each ``main`` prints the reference script's
lines and holds its own assertions (sync == pipelined, ``slo`` ==
``dsde`` with no deadlines, replay at arrival 0 == ``run()``, streamed
tokens == each request's output).  The scripts that would train a pair
for minutes serve the untrained pair instead (``monkeypatch``), at 8 new
tokens a request and, for the draft's training, 3 / 5 / 8 steps; their
serves' parity with the reference is held in ``test_torch_workloads.py``
and ``test_torch_loadgen.py``."""
import functools
import math

import pytest

from _jax_caches import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import workloads
from repro_torch.examples import (low_acceptance_regime, quickstart,
                                  serve_dynamic_sl, stream_serving,
                                  train_draft_model)

POLICIES = ("autoregressive", "static", "adaedl", "dsde", "goodput", "slo")


@pytest.fixture
def untrained(monkeypatch):
    """``build_pair`` of every regime gives the untrained pair, and
    ``workloads.serve`` serves 8 new tokens a request."""
    monkeypatch.setattr(workloads, "build_pair",
                        lambda regime="llama", device="cuda":
                        workloads.untrained_pair(device))
    monkeypatch.setattr(workloads, "serve",
                        functools.partial(workloads.serve, max_new=8))


def test_quickstart(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    m = out["dsde"]
    assert m["tokens_emitted"] == 8 * 32 and m["device"] == "cpu"
    assert all(len(s) == 32 for s in out["streams"])
    assert f"verification rounds : {m['rounds']}\n" in text
    assert "tok/s (cpu, reduced model)" in text
    assert text.count("  request ") == 3


@pytest.mark.parametrize("flags", [
    [],
    ["--drafter", "ngram", "--kv-quant", "int8"],
    ["--prefix-share", "0.5"],
])
def test_serve_dynamic_sl_smoke(capsys, flags):
    out = serve_dynamic_sl.main(["--smoke", "--device", "cpu", *flags])
    text = capsys.readouterr().out
    lines = text.splitlines()
    for policy in POLICIES:
        m = out[policy]
        row = [ln for ln in lines if ln.startswith(f"{policy:16s} ")]
        assert len(row) == 1, policy
        assert row[0].split()[1:4] == [str(m["rounds"]),
                                       f"{m['block_efficiency']:.2f}",
                                       f"{m['mean_acceptance']:.2f}"]
        assert m["requests_finished"] == 8 and m["tokens_emitted"] == 96
    assert out["streams"]["slo"] == out["streams"]["dsde"]
    assert "token streams byte-identical across schedules: OK" in text
    assert sum(ln.startswith("  round ") for ln in lines) == min(
        12, out["dsde"]["rounds"])
    if "--prefix-share" in flags:
        assert "common head of 16 tokens" in text
        assert out["dsde"]["prefix_cache_hit_blocks"] > 0
    if "--kv-quant" in flags:
        assert "kv_quant int8" in text
        assert out["dsde"]["drafter"] == "ngram"


def test_serve_dynamic_sl_refuses_share_of_one():
    with pytest.raises(SystemExit):
        serve_dynamic_sl.main(["--smoke", "--device", "cpu",
                               "--prefix-share", "1.0"])


def test_stream_serving_smoke(capsys):
    out = stream_serving.main(["--smoke", "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.count("tokens streamed, finish=length") == 3
    assert "token streams byte-identical: OK" in text
    point = out["replay"]["report"]
    assert point["requests_finished"] == point["requests"] == 6
    assert point["tokens_emitted"] == out["replay"]["tokens_emitted"]
    assert f"finished 6/6 ({point['tokens_emitted']} tokens)" in text
    assert out["replay_at_zero"]["requests_finished"] == 6


def test_train_draft_model(untrained, monkeypatch, tmp_path, capsys):
    stream = workloads.mixed_stream(total_per=2000)
    monkeypatch.setattr(workloads, "mixed_stream", lambda: stream)
    monkeypatch.setattr(train_draft_model, "CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(train_draft_model, "STEPS", (3, 5, 8))
    out = train_draft_model.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for steps in (3, 5, 8):
        m = out[f"static@{steps}"]
        assert math.isfinite(m["loss"])
        assert f"draft @ {steps:3d} steps: loss={m['loss']:.3f}" in text
    assert out["static@8"]["loss"] < out["static@3"]["loss"]
    assert out["static@8"]["tokens_emitted"] == 6 * 8
    assert (tmp_path / "latest").read_text() == "ckpt_00000008.npz"
    assert f"checkpointed trained draft to {tmp_path}" in text


def test_low_acceptance_regime(untrained, capsys):
    out = low_acceptance_regime.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for regime in ("llama", "gemma"):
        opt = out[f"{regime}/static-opt"]
        assert opt["k_opt"] in (2, 4, 6, 8, 10)
        assert f"static-opt: k_opt={opt['k_opt']}" in text
        for policy in ("dsde", "adaedl"):
            m = out[f"{regime}/{policy}"]
            assert math.isfinite(m["latency_units"])
            assert m["requests_finished"] == 9
    assert text.count("== llama pair (strong draft) ==") == 1
    assert text.count("== gemma pair (weak, divergent draft) ==") == 1
