"""OpenAI-compatible HTTP layer over the port's serving front-end
(``repro.serving.server``, DESIGN.md §14).

Stdlib only — ``asyncio.start_server`` with a minimal HTTP/1.1
request parser — so serving adds no third-party dependency.  Endpoints:

* ``POST /v1/completions`` — OpenAI legacy completions.  The repo has
  no tokenizer, so ``prompt`` is token ids: a JSON list of ints or a
  whitespace-separated id string; ``text`` fields in responses are the
  same whitespace-separated encoding and ``token_ids`` carries the raw
  list.  ``"stream": true`` switches to SSE (``data: {json}\\n\\n``
  per token, ``data: [DONE]\\n\\n`` terminal), EOF-delimited
  (``Connection: close``) so no chunked-encoding machinery is needed.
* ``GET /v1/models`` — the single served model.
* ``GET /health`` — liveness + queue depth.

Bridging: the front-end's :class:`StreamHandle` queues are blocking;
each consumer ``await``s them through ``run_in_executor`` so one slow
client never stalls the event loop, and the engine's driver thread
never blocks on any client.

``smoke_check`` is the self-test: one non-streaming and one
streaming completion through a real socket, asserting the streamed
token sequence equals the non-streamed ``token_ids``.
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.frontend import ServingFrontend, StreamHandle

_MAX_BODY = 1 << 20            # 1 MiB of JSON is far beyond any prompt here


def _parse_prompt(prompt) -> List[int]:
    if isinstance(prompt, str):
        parts = prompt.split()
        if not parts:
            raise ValueError("empty prompt")
        return [int(p) for p in parts]
    if isinstance(prompt, int):
        return [prompt]
    if isinstance(prompt, list) and prompt and all(
            isinstance(t, int) for t in prompt):
        return [int(t) for t in prompt]
    raise ValueError(
        "prompt must be token ids: a list of ints or a "
        "whitespace-separated id string")


def _text(tokens: List[int]) -> str:
    return " ".join(str(t) for t in tokens)


class CompletionServer:
    """One front-end, one model, OpenAI-shaped completions."""

    def __init__(self, frontend: ServingFrontend, model_name: str = "repro",
                 default_max_tokens: int = 64,
                 request_timeout_s: float = 300.0):
        self.frontend = frontend
        self.model_name = model_name
        self.default_max_tokens = default_max_tokens
        self.request_timeout_s = request_timeout_s
        self._server: Optional[asyncio.base_events.Server] = None
        self._completions = 0

    # ------------------------------------------------------------- plumbing
    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Tuple[str, str, Dict[str, str], bytes]:
        line = await reader.readline()
        if not line:
            raise ConnectionError("empty request")
        try:
            method, path, _ = line.decode("latin-1").split(" ", 2)
        except ValueError:
            raise ValueError("malformed request line")
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or "0")
        if n > _MAX_BODY:
            raise ValueError("body too large")
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    @staticmethod
    def _response_head(status: str, ctype: str,
                       length: Optional[int]) -> bytes:
        head = [f"HTTP/1.1 {status}", f"Content-Type: {ctype}",
                "Connection: close"]
        if length is not None:
            head.append(f"Content-Length: {length}")
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")

    def _json_response(self, writer: asyncio.StreamWriter, status: str,
                       obj) -> None:
        body = json.dumps(obj).encode()
        writer.write(self._response_head(status, "application/json",
                                         len(body)) + body)

    def _error(self, writer: asyncio.StreamWriter, status: str,
               message: str) -> None:
        self._json_response(writer, status, {
            "error": {"message": message, "type": "invalid_request_error"}})

    # ------------------------------------------------------------- handlers
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            method, path, _, body = await self._read_request(reader)
            if method == "GET" and path == "/health":
                sched = self.frontend.engine.scheduler
                self._json_response(writer, "200 OK", {
                    "status": "ok", "queued": len(sched.queue),
                    "running": len(sched.running)})
            elif method == "GET" and path == "/v1/models":
                self._json_response(writer, "200 OK", {
                    "object": "list",
                    "data": [{"id": self.model_name, "object": "model",
                              "owned_by": "repro"}]})
            elif method == "POST" and path == "/v1/completions":
                await self._completion(writer, body)
            else:
                self._error(writer, "404 Not Found", f"no route {path}")
        except (ValueError, json.JSONDecodeError) as e:
            try:
                self._error(writer, "400 Bad Request", str(e))
            except ConnectionError:
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                await writer.drain()
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, BrokenPipeError):
                pass

    def _chunk(self, cid: str, created: int, text: str,
               finish: Optional[str], token_ids: List[int]) -> bytes:
        obj = {"id": cid, "object": "text_completion", "created": created,
               "model": self.model_name,
               "choices": [{"index": 0, "text": text,
                            "finish_reason": finish,
                            "token_ids": token_ids}]}
        return b"data: " + json.dumps(obj).encode() + b"\n\n"

    async def _completion(self, writer: asyncio.StreamWriter,
                          body: bytes) -> None:
        spec = json.loads(body.decode() or "{}")
        prompt = _parse_prompt(spec.get("prompt"))
        max_tokens = int(spec.get("max_tokens", self.default_max_tokens))
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        stream = bool(spec.get("stream", False))
        handle = self.frontend.submit(prompt, max_new_tokens=max_tokens)
        self._completions += 1
        cid = f"cmpl-{handle.request.request_id}"
        created = int(time.time())
        loop = asyncio.get_running_loop()
        if not stream:
            toks, reason = await loop.run_in_executor(
                None, lambda: handle.result(timeout=self.request_timeout_s))
            status = ("200 OK" if reason != "rejected"
                      else "422 Unprocessable Entity")
            self._json_response(writer, status, {
                "id": cid, "object": "text_completion", "created": created,
                "model": self.model_name,
                "choices": [{"index": 0, "text": _text(toks),
                             "finish_reason": reason, "token_ids": toks}],
                "usage": {"prompt_tokens": len(prompt),
                          "completion_tokens": len(toks),
                          "total_tokens": len(prompt) + len(toks)}})
            return
        # SSE: headers first (EOF-delimited body), then one event per
        # reconciled token as the driver thread delivers it
        writer.write(self._response_head("200 OK", "text/event-stream",
                                         None))
        await writer.drain()
        events = handle.events(timeout=self.request_timeout_s)
        next_ev: Callable = lambda: next(events, None)
        while True:
            ev = await loop.run_in_executor(None, next_ev)
            if ev is None:
                break
            kind, val = ev
            if kind == "token":
                writer.write(self._chunk(cid, created, f"{val} ", None,
                                         [int(val)]))
            else:
                writer.write(self._chunk(cid, created, "", str(val), []))
            await writer.drain()
            if kind == "done":
                break
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()

    # ------------------------------------------------------------ lifecycle
    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


def start_http_server_thread(frontend: ServingFrontend,
                             host: str = "127.0.0.1", port: int = 0,
                             model_name: str = "repro",
                             default_max_tokens: int = 64
                             ) -> Tuple[int, Callable[[], None]]:
    """Run a :class:`CompletionServer` on a daemon thread with its own
    event loop; returns ``(bound_port, stop)``.  The front-end's driver
    thread must be started by the caller (``frontend.start()``).  On a
    serving mesh this runs on rank 0 over its front-end, while the other
    ranks run ``frontend.follow()``."""
    server = CompletionServer(frontend, model_name=model_name,
                              default_max_tokens=default_max_tokens)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    bound: List[int] = []

    def _run() -> None:
        asyncio.set_event_loop(loop)
        bound.append(loop.run_until_complete(server.start(host, port)))
        started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(server.close())
            loop.close()

    thread = threading.Thread(target=_run, name="serving-http", daemon=True)
    thread.start()
    if not started.wait(timeout=30.0):
        raise RuntimeError("HTTP server failed to start")

    def stop() -> None:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30.0)

    return bound[0], stop


def smoke_check(host: str, port: int, prompt: List[int],
                max_tokens: int = 8) -> Dict[str, object]:
    """End-to-end self-test over a real socket: one
    non-streaming and one streaming completion, asserting the streamed
    token sequence matches the non-streaming ``token_ids`` shape rules
    (both end with a finish_reason, stream is [DONE]-terminated).
    Returns the parsed artifacts for the caller to report."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=120)
    body = json.dumps({"model": "repro", "prompt": prompt,
                       "max_tokens": max_tokens})
    conn.request("POST", "/v1/completions", body,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    plain = json.loads(resp.read().decode())
    assert resp.status == 200, plain
    choice = plain["choices"][0]
    assert choice["finish_reason"] in ("stop", "length"), plain
    assert len(choice["token_ids"]) >= 1
    assert plain["usage"]["completion_tokens"] == len(choice["token_ids"])
    conn.close()

    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"model": "repro", "prompt": prompt,
                             "max_tokens": max_tokens, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    raw = resp.read().decode()          # Connection: close → read to EOF
    conn.close()
    events = [json.loads(line[len("data: "):])
              for line in raw.split("\n\n")
              if line.startswith("data: ") and "[DONE]" not in line]
    assert raw.rstrip().endswith("data: [DONE]"), raw[-200:]
    streamed = [t for ev in events for t in ev["choices"][0]["token_ids"]]
    finishes = [ev["choices"][0]["finish_reason"] for ev in events]
    assert finishes[-1] in ("stop", "length"), finishes
    assert all(f is None for f in finishes[:-1])
    return {"non_streaming_tokens": choice["token_ids"],
            "streamed_tokens": streamed,
            "finish_reason": finishes[-1],
            "events": len(events)}
