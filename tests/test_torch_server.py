"""The port's OpenAI-compatible HTTP layer (``repro_torch.serving.server``)
and its serve launcher (``repro_torch.launch.serve``), over real loopback
sockets.  One port engine and one reference engine (the same weights)
each behind a front-end and an HTTP server thread; every response of the
port's server is held to the port's own ``run()`` and to the reference
server's response for the same request."""
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.frontend import ServingFrontend
from repro.serving.server import start_http_server_thread as ref_http
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.frontend import ServingFrontend as TFrontend
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.server import (_parse_prompt, _text, smoke_check,
                                        start_http_server_thread)
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")

PROMPT = [3, 7, 11, 2, 9, 4]
SERVING = dict(max_batch_size=2, max_seq_len=128, paged_kv=True,
               kv_block_size=16, pipelined=True)


@pytest.fixture(scope="module")
def served():
    cfg = get_config("smollm-135m").reduced()
    pt = init_params(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    noise = init_params(model_specs(cfg), jax.random.PRNGKey(7), jnp.float32)
    pd = jax.tree_util.tree_map(lambda a, b: a + 0.05 * b, pt, noise)
    tcfg = t_get_config("smollm-135m").reduced()
    tpt, tpd = (from_reference(jax.tree_util.tree_map(np.asarray, p),
                               device="cpu") for p in (pt, pd))

    def engine():
        return TEngine(tpt, tcfg, tpd, tcfg, TSpec(policy="dsde"),
                       TServing(**SERVING), seed=0, device="cpu")

    fe = TFrontend(engine()).start()
    port, stop = start_http_server_thread(fe, model_name="repro-test")
    ref_fe = ServingFrontend(ServingEngine(
        pt, cfg, pd, cfg, SpecDecodeConfig(policy="dsde", temperature=0.0),
        ServingConfig(**SERVING), seed=0)).start()
    ref_port, ref_stop = ref_http(ref_fe, model_name="repro-test")
    # greedy streams do not depend on the request id: HTTP must give
    # run()'s stream for the same prompt
    run = TRequest(0, prompt=list(PROMPT), max_new_tokens=6)
    engine().run([run])
    yield {"port": port, "ref_port": ref_port, "frontend": fe,
           "run": run.output}
    stop()
    fe.stop()
    ref_stop()
    ref_fe.stop()


def _post(port, obj, path="/v1/completions", raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, raw if raw is not None else json.dumps(obj),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, resp.getheader("Content-Type"), resp.read().decode()
    conn.close()
    return out


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read().decode())
    conn.close()
    return out


def _strip(obj):
    """A completion without its per-call fields (id, creation time)."""
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


def _sse(raw):
    lines = [ln for ln in raw.split("\n\n") if ln.startswith("data: ")]
    assert lines[-1].strip() == "data: [DONE]"
    return [_strip(json.loads(ln[len("data: "):])) for ln in lines[:-1]]


def test_non_streaming_completion_matches_run_and_reference(served):
    req = {"model": "repro-test", "prompt": PROMPT, "max_tokens": 6}
    status, ctype, body = _post(served["port"], req)
    assert (status, ctype) == (200, "application/json")
    out = json.loads(body)
    choice = out["choices"][0]
    assert choice["token_ids"] == served["run"]
    assert choice["text"] == _text(served["run"])
    assert choice["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": 6, "completion_tokens": 6,
                            "total_tokens": 12}
    ref = _post(served["ref_port"], req)
    assert (status, ctype) == ref[:2]
    assert _strip(out) == _strip(json.loads(ref[2]))


@pytest.mark.parametrize("prompt", [PROMPT, " ".join(map(str, PROMPT))],
                         ids=["ids", "id-string"])
def test_streaming_sse_matches_run_and_reference(served, prompt):
    req = {"prompt": prompt, "max_tokens": 6, "stream": True}
    status, ctype, raw = _post(served["port"], req)
    assert (status, ctype) == (200, "text/event-stream")
    events = _sse(raw)
    assert [t for ev in events for t in ev["choices"][0]["token_ids"]] == (
        served["run"])
    assert [ev["choices"][0]["finish_reason"] for ev in events] == (
        [None] * 6 + ["length"])
    ref = _post(served["ref_port"], req)
    assert ref[:2] == (status, ctype)
    assert events == _sse(ref[2])


def test_smoke_check_self_test(served):
    res = smoke_check("127.0.0.1", served["port"], PROMPT, max_tokens=6)
    assert res["streamed_tokens"] == res["non_streaming_tokens"] == served["run"]
    assert res["events"] == 7 and res["finish_reason"] == "length"


def test_health_and_models_match_reference(served):
    for path in ("/health", "/v1/models"):
        got = _get(served["port"], path)
        assert got == _get(served["ref_port"], path), path
    status, health = _get(served["port"], "/health")
    assert status == 200 and health["status"] == "ok"
    assert _get(served["port"], "/v1/models")[1]["data"][0]["id"] == "repro-test"


@pytest.mark.parametrize("case", [
    ("/v1/chat", {"prompt": PROMPT}, None),
    ("/v1/completions", {"max_tokens": 4}, None),
    ("/v1/completions", {"prompt": "not token ids"}, None),
    ("/v1/completions", {"prompt": PROMPT, "max_tokens": 0}, None),
    ("/v1/completions", None, "{nope"),
], ids=["no-route", "no-prompt", "bad-prompt", "zero-tokens", "bad-json"])
def test_error_statuses_match_reference(served, case):
    path, obj, raw = case
    got = _post(served["port"], obj, path=path, raw=raw)
    assert got[0] in (400, 404)
    assert got == _post(served["ref_port"], obj, path=path, raw=raw)


def test_parse_prompt_forms():
    assert _parse_prompt([1, 2, 3]) == [1, 2, 3]
    assert _parse_prompt("4 5 6") == [4, 5, 6]
    assert _parse_prompt(7) == [7]
    for bad in (None, "", [], [1, "x"], {"a": 1}):
        with pytest.raises(ValueError):
            _parse_prompt(bad)


def test_concurrent_streaming_clients(served):
    outs = [None] * 3

    def stream(i):
        _, _, raw = _post(served["port"], {"prompt": PROMPT, "max_tokens": 6,
                                           "stream": i != 2})
        if i == 2:
            outs[i] = json.loads(raw)["choices"][0]["token_ids"]
        else:
            outs[i] = [t for ev in _sse(raw)
                       for t in ev["choices"][0]["token_ids"]]

    threads = [threading.Thread(target=stream, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert outs == [served["run"]] * 3


# ---------------------------------------------------------------------------
# The serve launcher
# ---------------------------------------------------------------------------

def test_launcher_demo_on_cpu():
    m = launch_serve.main(["--arch", "smollm-135m", "--demo", "--device", "cpu",
                           "--requests", "6", "--max-new", "6", "--paged",
                           "--prefix-share", "0.5", "--pipelined"])
    assert m["requests_finished"] == 6 and m["tokens_emitted"] == 36
    assert m["device"] == "cpu" and m["kv_pool_blocks"] == 32
    assert m["prefix_cache_hit_blocks"] > 0 and m["prefix_cache_hit_rate"] > 0


@pytest.mark.parametrize("drafter,kv_quant", [("ngram", "int8"),
                                              ("self", "none")])
def test_launcher_demo_drafters(drafter, kv_quant):
    m = launch_serve.main(["--arch", "smollm-135m", "--demo", "--device", "cpu",
                           "--requests", "2", "--max-new", "4", "--drafter",
                           drafter, "--kv-quant", kv_quant, "--policy",
                           "static", "--slo-deadline", "1,0.5"])
    assert m["requests_finished"] == 2 and m["drafter"] == drafter
    assert m["kv_quant"] == kv_quant


def test_launcher_http_smoke_on_cpu():
    out = launch_serve.main(["--arch", "smollm-135m", "--http-smoke",
                             "--device", "cpu"])
    assert out["streamed_tokens"] == out["non_streaming_tokens"]
    assert len(out["streamed_tokens"]) == 8 and out["events"] == 9
    assert out["summary"]["requests_finished"] == 2


@pytest.mark.parametrize("extra,word", [
    (["--demo", "--mesh", "1x4", "--arch", "granite-moe-3b-a800m"],
     "torchrun"),
    (["--http", "--mesh", "1x4"], "torchrun"),
    (["--demo", "--mesh", "1x4", "--prefix-share", "0.5"], "torchrun"),
    (["--demo", "--mesh", "1x4"], "torchrun"),
    (["--mesh", "1x4"], "--http-smoke")])
def test_launcher_unported_modes_exit_with_an_error(extra, word, capsys,
                                                    monkeypatch):
    """``--mesh`` outside torchrun (for any arch and serving mode: an MoE
    arch, the HTTP front door and prefix caching pass every other check)
    and ``--mesh`` with the dry run, which serves nothing, exit with an
    error before any process group starts."""
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit) as e:
        launch_serve.main(["--arch", "smollm-135m", "--device", "cpu"] + extra)
    assert e.value.code == 2
    assert word in capsys.readouterr().err


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_launcher_default_mode_is_the_dry_run(shape):
    """The default mode dry-runs the serve step on the 16 x 16 mesh (here
    the reduced config): a record of the reference's keys, per-device
    counts, the H100 roofline, the ring kernel once a layer."""
    rec = launch_serve.main(["--arch", "smollm-135m", "--reduced",
                             "--shape", shape])
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["mesh"] == "16x16" and rec["shape"] == shape
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "bottleneck", "eager_memory_s",
                                    "useful_flops_ratio"}
    mem, roof = rec["memory"], rec["roofline"]
    # the memory term is the bytes the step must move, not the eager count
    assert roof["memory_s"] == pytest.approx(
        (mem["argument_bytes"] + mem["output_bytes"]) / 3.35e12)
    assert roof["eager_memory_s"] > roof["memory_s"]
    assert rec["kernel_calls"] == {"ragged_verify_attention": 2.0}
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert 0 < mem["peak_share_of_hbm"] < 1
