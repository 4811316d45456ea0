"""OpenAI-compatible HTTP frontend over the serving engine (stdlib only;
counterpart of ``ssp_x_vit_tpu/llm/server_http.py``).

Endpoints (the subset of the OpenAI REST surface a drop-in client needs):

- ``GET  /health``                liveness probe
- ``GET  /v1/models``             single-model listing
- ``POST /v1/completions``        text completion, optional SSE streaming
- ``POST /v1/chat/completions``   chat completion, optional SSE streaming

Together with :mod:`ssp_x_vit_tpu_torch.llm.engine` it makes the paged
continuous-batching stack consumable by standard OpenAI SDK clients.

Two prompt modes:

- with a tokenizer (``llm.tokenizer.load_tokenizer``'s, or anything with
  ``encode``/``decode``): ``prompt`` is a string (or list of strings → one
  choice each), responses carry decoded ``text``, and ``stop`` strings are
  honored (generation is cancelled server-side as soon as a stop string
  appears in the decoded tail — tokens after the match are truncated).
- without a tokenizer (tokenizer=None): ``prompt`` must be a token-id list;
  responses carry ``token_ids`` (an extension field) and empty ``text``.
  ``stop_token_ids`` (extension) works in both modes.

Sampling params map 1:1 onto :class:`ssp_x_vit_tpu_torch.llm.sampling.SamplingParams`
(OpenAI names: ``temperature``, ``top_p``, ``presence_penalty``,
``frequency_penalty``; extensions: ``top_k``, ``min_p``,
``repetition_penalty``, ``seed``). ``temperature=0`` is greedy. Purely
greedy, penalty-free requests skip the device sampler entirely (the
engine's zero-overhead host-argmax path).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple

from ssp_x_vit_tpu_torch.llm.engine import RequestHandle, ServingEngine
from ssp_x_vit_tpu_torch.llm.sampling import SamplingParams

__all__ = ["ApiError", "create_server", "serve_forever"]


class ApiError(Exception):
    def __init__(self, message: str, status: int = 400,
                 err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type


def _sampling_from_request(body: dict) -> Tuple[Optional[SamplingParams],
                                                Optional[int]]:
    """OpenAI request fields -> (SamplingParams | None, seed). None means the
    pure-greedy host path (no device sampler state is allocated)."""
    temperature = float(body.get("temperature", 1.0))
    top_p = body.get("top_p")
    top_k = body.get("top_k")
    min_p = body.get("min_p")
    rep = float(body.get("repetition_penalty", 1.0))
    presence = float(body.get("presence_penalty", 0.0))
    frequency = float(body.get("frequency_penalty", 0.0))
    seed = body.get("seed")
    if seed is not None:
        seed = int(seed)
    top_p = None if top_p is None or float(top_p) >= 1.0 else float(top_p)
    top_k = None if top_k is None or int(top_k) <= 0 else int(top_k)
    min_p = None if min_p is None or float(min_p) <= 0.0 else float(min_p)
    greedy = (temperature <= 0.0 and rep == 1.0 and presence == 0.0
              and frequency == 0.0)
    if greedy:
        return None, None
    try:
        sp = SamplingParams(
            temperature=max(temperature, 0.0), top_k=top_k, top_p=top_p,
            min_p=min_p, repetition_penalty=rep, presence_penalty=presence,
            frequency_penalty=frequency)
    except ValueError as e:
        raise ApiError(str(e))
    return sp, seed


def _render_chat(messages: Sequence[dict]) -> str:
    """Generic role-tagged template (the native tokenizer carries no model
    chat template; a deployment that needs an exact HF template should
    pre-render client-side and call /v1/completions)."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if not isinstance(content, str):
            raise ApiError("message content must be a string")
        parts.append(f"<|{role}|>\n{content}")
    parts.append("<|assistant|>\n")
    return "\n".join(parts)


class _StreamState:
    """Incremental detokenizer with a UTF-8 tail guard and stop-string
    holdback: emitted text never contains a replacement character from a
    split multi-byte sequence, and never reveals a prefix of a stop string
    that later completes."""

    def __init__(self, tokenizer, stop: Sequence[str]):
        self.tokenizer = tokenizer
        self.stop = [s for s in stop if s]
        self.holdback = max((len(s) for s in self.stop), default=0)
        self.ids: List[int] = []
        self.sent = 0          # chars of decoded text already emitted
        self.stopped = False

    def push(self, token: int) -> str:
        """Add one token; returns the newly safe-to-emit text delta.
        Sets ``self.stopped`` when a stop string completed (the delta is
        truncated just before the match). Tokens after the stop add nothing:
        the engine may still deliver the rest of a decode block it produced
        before the cancel (the JAX server's detokenizer emits their text)."""
        if self.stopped:
            return ""
        self.ids.append(token)
        text = self.tokenizer.decode(self.ids)
        if text.endswith("�"):   # split multi-byte sequence: wait
            return ""
        for s in self.stop:
            pos = text.find(s, max(0, self.sent - self.holdback))
            if pos != -1:
                self.stopped = True
                delta = text[self.sent:pos]
                self.sent = len(text)
                return delta
        safe = len(text) if not self.holdback else max(
            self.sent, len(text) - self.holdback)
        delta = text[self.sent:safe]
        self.sent = safe
        return delta

    def finalize(self) -> str:
        """Emit any held-back tail (called when generation ends)."""
        if self.stopped:
            return ""
        text = self.tokenizer.decode(self.ids)
        delta = text[self.sent:]
        self.sent = len(text)
        return delta


def create_server(engine: ServingEngine, *, tokenizer=None,
                  host: str = "127.0.0.1", port: int = 8000,
                  model_name: str = "ssp-x-vit-torch",
                  eos_token_id: Optional[int] = None,
                  max_tokens_cap: int = 2048) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server. ``serve_forever`` or
    ``threading.Thread(target=srv.serve_forever)`` to run; ``srv.shutdown()``
    to stop. The engine is NOT shut down by the server."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # ---------- plumbing ----------

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, status: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, e: ApiError):
            self._json(e.status, {"error": {
                "message": str(e), "type": e.err_type}})

        def _body(self) -> dict:
            try:
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n) if n else b"{}"
                body = json.loads(raw or b"{}")
            except (ValueError, json.JSONDecodeError):
                raise ApiError("request body is not valid JSON")
            if not isinstance(body, dict):
                raise ApiError("request body must be a JSON object")
            return body

        # ---------- GET ----------

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": model_name, "object": "model",
                    "created": int(time.time()),
                    "owned_by": "ssp_x_vit_tpu_torch"}]})
            else:
                self._json(404, {"error": {"message": "not found",
                                           "type": "not_found"}})

        # ---------- POST ----------

        def do_POST(self):
            try:
                if self.path == "/v1/completions":
                    self._completions(chat=False)
                elif self.path == "/v1/chat/completions":
                    self._completions(chat=True)
                else:
                    raise ApiError("not found", status=404,
                                   err_type="not_found")
            except ApiError as e:
                self._error(e)
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001 — report, don't kill thread
                self._error(ApiError(f"internal error: {e}", status=500,
                                     err_type="server_error"))

        # ---------- request decoding ----------

        def _prompt_ids(self, body: dict, chat: bool) -> List[int]:
            if chat:
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages:
                    raise ApiError("'messages' must be a non-empty list")
                if tokenizer is None:
                    raise ApiError("chat endpoint requires a tokenizer "
                                   "(server started without one)")
                return tokenizer.encode(_render_chat(messages))
            prompt = body.get("prompt")
            if isinstance(prompt, str):
                if tokenizer is None:
                    raise ApiError("string prompts require a tokenizer; "
                                   "pass a token-id list")
                return tokenizer.encode(prompt)
            if isinstance(prompt, list) and prompt and \
                    all(isinstance(t, int) for t in prompt):
                return [int(t) for t in prompt]
            raise ApiError("'prompt' must be a string or a non-empty "
                           "list of token ids")

        def _stops(self, body: dict) -> Tuple[List[str], List[int]]:
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            if not isinstance(stop, list) or \
                    not all(isinstance(s, str) for s in stop):
                raise ApiError("'stop' must be a string or list of strings")
            if stop and tokenizer is None:
                raise ApiError("'stop' strings require a tokenizer; "
                               "use 'stop_token_ids'")
            stop_ids = body.get("stop_token_ids") or []
            if not isinstance(stop_ids, list) or \
                    not all(isinstance(t, int) for t in stop_ids):
                raise ApiError("'stop_token_ids' must be a list of ints")
            return stop, [int(t) for t in stop_ids]

        # ---------- completion core ----------

        def _completions(self, chat: bool):
            body = self._body()
            ids = self._prompt_ids(body, chat)
            stop, stop_ids = self._stops(body)
            max_tokens = int(body.get("max_tokens", 16))
            if not (0 < max_tokens <= max_tokens_cap):
                raise ApiError(
                    f"max_tokens must be in [1, {max_tokens_cap}]")
            sp, seed = _sampling_from_request(body)
            stream = bool(body.get("stream", False))
            eos = body.get("eos_token_id", eos_token_id)

            handle = engine.submit(
                ids, max_new_tokens=max_tokens, eos_token_id=eos,
                sampling=sp, seed=seed, stop_token_ids=stop_ids)
            rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
            if stream:
                self._respond_stream(handle, rid, chat, stop, eos, stop_ids)
            else:
                self._respond_once(handle, rid, chat, stop, eos, stop_ids,
                                   len(ids))

        def _strip_terminal(self, ids: List[int], eos, extra) -> List[int]:
            """Drop a trailing eos/stop token from the visible output (OpenAI
            semantics: the stop sequence is not part of the text)."""
            terminal = set(extra or [])
            if eos is not None:
                terminal.add(int(eos))
            if ids and ids[-1] in terminal:
                return ids[:-1]
            return ids

        def _respond_once(self, handle: RequestHandle, rid: str, chat: bool,
                          stop: List[str], eos, stop_ids: List[int],
                          n_prompt: int):
            stream_state = (_StreamState(tokenizer, stop)
                            if tokenizer is not None else None)
            terminal = set(stop_ids) | (
                {int(eos)} if eos is not None else set())
            text_parts: List[str] = []
            for ev in handle:
                if ev.kind == "error":
                    raise ApiError(ev.error)
                if ev.kind == "token" and stream_state is not None \
                        and ev.token not in terminal:
                    text_parts.append(stream_state.push(ev.token))
                    if stream_state.stopped:
                        engine.cancel(handle, reason="stop")
            if stream_state is not None and not stream_state.stopped:
                # drop a terminal eos/stop token, then flush the holdback
                kept = self._strip_terminal(stream_state.ids, eos, stop_ids)
                stream_state.ids = kept
                stream_state.sent = min(stream_state.sent, len(
                    tokenizer.decode(kept)))
                text_parts.append(stream_state.finalize())
            # A completed stop string wins over the engine's reason: with
            # multi-step decode blocks the slot may exhaust its budget
            # in-graph ("length") in the same block the stop string lands
            # (the cancel then races a finished request) — the client-visible
            # contract is the vLLM one: text truncated at the stop string,
            # finish_reason "stop".
            if stream_state is not None and stream_state.stopped:
                finish = "stop"
            else:
                finish = handle.finish_reason or "stop"
            visible = self._strip_terminal(handle.tokens, eos, stop_ids)
            out = {
                "id": rid,
                "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()),
                "model": model_name,
                "usage": {"prompt_tokens": n_prompt,
                          "completion_tokens": len(handle.tokens),
                          "total_tokens": n_prompt + len(handle.tokens)},
            }
            text = "".join(text_parts)
            if chat:
                out["choices"] = [{
                    "index": 0, "finish_reason": finish,
                    "message": {"role": "assistant", "content": text}}]
            else:
                out["choices"] = [{
                    "index": 0, "finish_reason": finish, "text": text,
                    "token_ids": visible}]
            self._json(200, out)

        def _respond_stream(self, handle: RequestHandle, rid: str,
                            chat: bool, stop: List[str], eos,
                            stop_ids: List[int]):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def emit(obj: dict):
                self.wfile.write(b"data: " + json.dumps(obj).encode()
                                 + b"\n\n")
                self.wfile.flush()

            def chunk(delta_text: str, token: Optional[int],
                      finish: Optional[str]) -> dict:
                if chat:
                    delta = {} if finish else {"content": delta_text}
                    if token is not None and not finish:
                        delta["token_ids"] = [token]
                    choice = {"index": 0, "delta": delta,
                              "finish_reason": finish}
                else:
                    choice = {"index": 0, "text": delta_text,
                              "finish_reason": finish}
                    if token is not None and not finish:
                        choice["token_ids"] = [token]
                return {"id": rid,
                        "object": ("chat.completion.chunk" if chat
                                   else "text_completion"),
                        "created": int(time.time()),
                        "model": model_name, "choices": [choice]}

            stream_state = (_StreamState(tokenizer, stop)
                            if tokenizer is not None else None)
            terminal = set(stop_ids) | (
                {int(eos)} if eos is not None else set())
            try:
                for ev in handle:
                    if ev.kind == "error":
                        emit({"error": {"message": ev.error,
                                        "type": "invalid_request_error"}})
                        break
                    if ev.kind == "token":
                        if ev.token in terminal:
                            continue  # generation ends here; await "done"
                        if stream_state is not None:
                            delta = stream_state.push(ev.token)
                            if stream_state.stopped:
                                engine.cancel(handle, reason="stop")
                            if delta:
                                emit(chunk(delta, ev.token, None))
                        elif ev.token not in terminal:
                            emit(chunk("", ev.token, None))
                    else:  # done
                        if stream_state is not None and \
                                not stream_state.stopped:
                            kept = self._strip_terminal(
                                stream_state.ids, eos, stop_ids)
                            stream_state.ids = kept
                            stream_state.sent = min(
                                stream_state.sent,
                                len(tokenizer.decode(kept)))
                            tail = stream_state.finalize()
                            if tail:
                                emit(chunk(tail, None, None))
                        if stream_state is not None and stream_state.stopped:
                            emit(chunk("", None, "stop"))  # see _respond_once
                        else:
                            emit(chunk("", None, ev.finish_reason or "stop"))
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except BrokenPipeError:
                engine.cancel(handle, reason="cancelled")

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.daemon_threads = True
    return srv


def serve_forever(engine: ServingEngine, **kwargs):
    """Blocking convenience wrapper: build the server and run until SIGINT."""
    srv = create_server(engine, **kwargs)
    host, port = srv.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} "
          f"(/v1/completions, /v1/chat/completions)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
