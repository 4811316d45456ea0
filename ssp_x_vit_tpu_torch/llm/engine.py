"""Threaded continuous-batching serving engine over the paged server
(counterpart of ``ssp_x_vit_tpu/llm/engine.py``).

A single engine thread owns the :class:`~ssp_x_vit_tpu_torch.llm.paged.PagedServer`
and with it every CUDA call after construction (it sets the server's device as
its current device when it starts), admits queued requests into free decode
slots, steps the batched decode loop while anything is active, and streams
freshly decoded tokens to per-request subscriber queues.

Design notes
------------
- **One device thread.** ``PagedServer`` methods (prefill, decode step) are
  only ever called from the engine loop; ``submit``/``cancel`` touch pure-Python
  queues under a lock and wake the loop.
- **Continuous batching.** Admission is attempted every loop iteration, so a
  request that arrives mid-generation joins the running batch at the next
  decode block (the vLLM scheduling model) instead of waiting for the batch
  to drain. Admission-time prefill briefly pauses decoding, exactly like
  vLLM's default scheduler; ``chunked_prefill`` bounds each pause.
- **Backpressure, not failure.** A request that cannot be admitted yet (no
  free slot, or the page pool cannot cover its worst case) simply stays
  queued; only a request that can never fit (longer than ``max_context``)
  is failed with an error event.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from ssp_x_vit_tpu_torch.llm.deepseek import is_deepseek
from ssp_x_vit_tpu_torch.llm.model import LlamaConfig, Params
from ssp_x_vit_tpu_torch.llm.paged import PagedServer

__all__ = ["GenerationEvent", "RequestHandle", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class GenerationEvent:
    """One item on a request's event queue.

    ``kind`` is ``"token"`` (one new token id), ``"done"`` (generation over,
    ``finish_reason`` in {"stop", "length", "cancelled"}), or ``"error"``
    (request rejected; ``error`` holds the message).
    """

    kind: str
    token: int = -1
    finish_reason: str = ""
    error: str = ""


class RequestHandle:
    """Caller-side view of a submitted request.

    Iterate to receive :class:`GenerationEvent` items as they are produced
    (the iterator ends after the terminal ``done``/``error`` event), or call
    :meth:`result` to block until completion and get the generated ids.
    """

    def __init__(self, prompt_ids: List[int]):
        self.prompt_ids = prompt_ids
        self.events: "queue.Queue[GenerationEvent]" = queue.Queue()
        self.request_id: Optional[int] = None  # set at admission
        self.tokens: List[int] = []            # engine-thread appends
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None

    def __iter__(self):
        while True:
            ev = self.events.get()
            yield ev
            if ev.kind in ("done", "error"):
                return

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes; returns the generated token ids
        (including the stop token when generation ended on one). Raises
        ``RuntimeError`` on a rejected request or ``TimeoutError`` if the
        terminal event does not arrive in ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[int] = []
        while True:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError("generation did not finish in time")
            try:
                ev = self.events.get(timeout=left)
            except queue.Empty:
                raise TimeoutError("generation did not finish in time")
            if ev.kind == "token":
                out.append(ev.token)
            elif ev.kind == "error":
                raise RuntimeError(ev.error)
            else:
                return out


@dataclasses.dataclass
class _Pending:
    handle: RequestHandle
    max_new_tokens: int
    eos_token_id: Optional[int]
    sampling: object
    seed: Optional[int]
    stop_token_ids: tuple


class ServingEngine:
    """Background continuous-batching engine; see module docstring.

    Constructor arguments mirror :class:`PagedServer`; the engine owns the
    server instance and its lifecycle. Always ``shutdown()`` (or use as a
    context manager) so the engine thread exits before interpreter teardown.
    """

    def __init__(self, params: Params, cfg: LlamaConfig, *,
                 max_batch: int = 4, num_pages: int = 128,
                 page_size: int = 64, max_context: int = 1024,
                 cache_dtype=None, chunked_prefill: Optional[int] = None,
                 prefix_cache: bool = False, decode_block: int = 8):
        server_cls = PagedServer
        if is_deepseek(cfg):
            # the MLA family: the compressed-latent pool server, same machinery and API
            from ssp_x_vit_tpu_torch.llm.paged_mla import MLAPagedServer

            server_cls = MLAPagedServer
        self._server = server_cls(
            params, cfg, max_batch=max_batch, num_pages=num_pages, page_size=page_size,
            max_context=max_context, cache_dtype=cache_dtype or torch.bfloat16,
            chunked_prefill=chunked_prefill, prefix_cache=prefix_cache)
        self.cfg = cfg
        # decode_block: decode steps between admission points with one copy
        # back to the host (PagedServer.step_many); bounds a newly arrived
        # request's join latency to one block. 1 = one step per round trip.
        self.decode_block = max(1, int(decode_block))
        self._pending: "collections.deque[_Pending]" = collections.deque()
        self._live: Dict[int, _Pending] = {}       # request_id -> pending rec
        self._emitted: Dict[int, int] = {}         # request_id -> tokens sent
        self._cancel: Dict[int, str] = {}          # request_id -> reason
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._loop, name="ssp-serving-engine", daemon=True)
        self._thread.start()

    # ---------------- public, any-thread ----------------

    def submit(self, prompt_ids: Sequence[int], *, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, sampling=None,
               seed: Optional[int] = None,
               stop_token_ids: Sequence[int] = ()) -> RequestHandle:
        """Queue a request; returns immediately with a :class:`RequestHandle`.

        ``stop_token_ids`` are additional terminal tokens beyond
        ``eos_token_id`` (the engine cancels the slot when one is produced,
        finish_reason "stop")."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        handle = RequestHandle(prompt)
        if not prompt:
            handle.error = "empty prompt"
            handle.events.put(GenerationEvent("error", error=handle.error))
            return handle
        rec = _Pending(handle, int(max_new_tokens), eos_token_id, sampling,
                       seed, tuple(int(t) for t in stop_token_ids))
        with self._lock:
            if self._shutdown:
                raise RuntimeError("engine is shut down")
            self._pending.append(rec)
        self._wake.set()
        return handle

    def cancel(self, handle: RequestHandle, reason: str = "cancelled"):
        """Abort a request. Pending requests are dropped immediately; active
        ones finish at the next loop iteration with ``finish_reason=reason``."""
        with self._lock:
            for rec in list(self._pending):
                if rec.handle is handle:
                    self._pending.remove(rec)
                    handle.finish_reason = reason
                    handle.events.put(
                        GenerationEvent("done", finish_reason=reason))
                    return
            if handle.request_id is not None and \
                    handle.request_id in self._live:
                self._cancel[handle.request_id] = reason
        self._wake.set()

    def shutdown(self):
        with self._lock:
            self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    @property
    def prefix_hit_pages(self) -> int:
        return self._server.prefix_hit_pages

    @property
    def decode_steps(self) -> int:
        return self._server.decode_steps

    # ---------------- engine thread ----------------

    def _loop(self):
        if self._server.device.type == "cuda":
            torch.cuda.set_device(self._server.device)
        while True:
            with self._lock:
                if self._shutdown:
                    for rid, rec in self._live.items():
                        rec.handle.finish_reason = "cancelled"
                        rec.handle.events.put(
                            GenerationEvent("done", finish_reason="cancelled"))
                    self._live.clear()
                    for rec in self._pending:
                        rec.handle.finish_reason = "cancelled"
                        rec.handle.events.put(
                            GenerationEvent("done", finish_reason="cancelled"))
                    self._pending.clear()
                    return
                cancels = dict(self._cancel)
                self._cancel.clear()
            try:
                for rid, reason in cancels.items():
                    if self._server.cancel(rid):
                        self._finish_request(rid, reason)
                self._admit()
                if self._server.step_many(self.decode_block):
                    self._flush_active()
                    self._flush_finished()
                else:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception as e:  # noqa: BLE001 — a dead engine thread
                # would leave every client blocked on its event queue forever;
                # fail everything loudly instead and stop.
                msg = f"serving engine crashed: {type(e).__name__}: {e}"
                with self._lock:
                    self._shutdown = True
                    for rec in list(self._live.values()) + list(self._pending):
                        rec.handle.error = msg
                        rec.handle.events.put(
                            GenerationEvent("error", error=msg))
                    self._live.clear()
                    self._pending.clear()
                raise

    def _admit(self):
        """Admit queued requests into free slots until one doesn't fit."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                if not any(not s.active for s in self._server.slots):
                    return
                rec = self._pending.popleft()
            h = rec.handle
            worst = -(-(len(h.prompt_ids) + rec.max_new_tokens)
                      // self._server.page_size)
            if worst > self._server.max_pages_per_seq:
                h.error = (f"prompt+max_tokens needs {worst} pages, "
                           f"max_context allows "
                           f"{self._server.max_pages_per_seq}")
                h.events.put(GenerationEvent("error", error=h.error))
                continue
            try:
                rid = self._server.add_request(
                    h.prompt_ids, max_new_tokens=rec.max_new_tokens,
                    eos_token_id=rec.eos_token_id, sampling=rec.sampling,
                    seed=rec.seed)
            except RuntimeError:
                # pool cannot cover the worst case RIGHT NOW: requeue at the
                # front and stop admitting until something finishes
                with self._lock:
                    self._pending.appendleft(rec)
                return
            h.request_id = rid
            self._live[rid] = rec
            self._emitted[rid] = 0
            self._flush_active()
            self._flush_finished()

    def _emit(self, rid: int, generated: Sequence[int]) -> bool:
        """Send tokens beyond the emitted watermark; returns True when a
        stop_token_id was hit (caller should cancel the slot)."""
        rec = self._live[rid]
        h = rec.handle
        start = self._emitted[rid]
        for tok in list(generated)[start:]:
            h.tokens.append(int(tok))
            h.events.put(GenerationEvent("token", token=int(tok)))
            self._emitted[rid] += 1
            if int(tok) in rec.stop_token_ids:
                return True
        return False

    def _flush_active(self):
        for slot in self._server.slots:
            if slot.active and slot.request_id in self._live:
                if self._emit(slot.request_id, slot.generated):
                    self._server.cancel(slot.request_id)
                    self._finish_request(slot.request_id, "stop")

    def _flush_finished(self):
        done = [rid for rid in self._live if rid in self._server.finished]
        for rid in done:
            rec = self._live[rid]
            seq = self._server.finished[rid]
            generated = list(seq[len(rec.handle.prompt_ids):])
            stop_hit = self._emit(rid, generated)
            last = generated[-1] if generated else -1
            reason = "stop" if (stop_hit or (
                rec.eos_token_id is not None and last == rec.eos_token_id)
            ) else "length"
            self._finish_request(rid, reason)

    def _finish_request(self, rid: int, reason: str):
        rec = self._live.pop(rid, None)
        self._emitted.pop(rid, None)
        self._server.finished.pop(rid, None)
        if rec is not None:
            rec.handle.finish_reason = reason
            rec.handle.events.put(
                GenerationEvent("done", finish_reason=reason))
