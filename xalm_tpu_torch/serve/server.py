"""OpenAI-compatible HTTP server over the continuous batcher (counterpart
of ``xalm_tpu/serve/server.py``): ``/v1/models``, ``/v1/completions`` and
``/v1/chat/completions`` (JSON and SSE streaming, ``logprobs``, ``stop``,
``n``, ``echo``, cancel on disconnect) and ``/health``, on the standard
library's ``http.server``.

Threads: one scheduler thread owns the engine and the ContinuousBatcher.
It drains the submission inbox, runs ``step()`` ticks and fans the tokens
out through one queue a request, which the handler threads stream from.
The handler threads touch no tensor and no CUDA call: they parse,
tokenize and enqueue. Every CUDA graph the loop can replay is captured in
``ContinuousBatcher.warmup`` before the HTTP server starts. Per-request
sampling (temperature, top_p, seed) rides the batcher's per-slot threefry
keys: a sampled request's stream depends on its seed alone.

Usage: python -m xalm_tpu_torch.serve.server model.xalm [--port 8000]
       [--max-batch 8] [--kv auto|f16|bf16|f32|i8] [--q4 GROUP] [-d cuda|cpu]
--tp and --dp above 1 are refused: the port has no sharded engine yet.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from xalm_tpu_torch.serve.batching import ContinuousBatcher, Request

__all__ = ["XalmServer", "main"]

_DONE = object()  # per-request token-queue sentinel


NO_ROW_SAMPLER = ("this engine has no per-row sampled scan (ShardedEngine): submit greedy "
                  "requests without logprobs")


class XalmServer:
    """Owns the scheduler thread + HTTP server around one engine."""

    def __init__(self, engine, *, max_batch: int = 8, model_name: str = "xalm",
                 warmup: bool = True):
        self.engine = engine
        self.model_name = model_name
        self.batcher = ContinuousBatcher(engine, max_batch=max_batch)
        if warmup:
            # build and capture every serving step before traffic (and
            # before any handler thread exists); an engine without the
            # per-row sampled scan serves greedy requests only
            dt = self.batcher.warmup(sampled=engine.sample_scan_rows is not None)
            print(f"server warmup: {dt:.1f}s (every serving step built and captured)",
                  flush=True)
        self._inbox: queue.Queue = queue.Queue()
        self._cancels: queue.Queue = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._n_completed = 0
        self._req_queues: dict[int, queue.Queue] = {}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ scheduler

    def _loop(self) -> None:
        b = self.batcher
        while not self._stop.is_set():
            moved = False
            while True:
                try:
                    req, tq = self._inbox.get_nowait()
                except queue.Empty:
                    break
                rid = b.submit(req)
                self._req_queues[rid] = tq
                moved = True
            while True:
                try:
                    creq = self._cancels.get_nowait()
                except queue.Empty:
                    break
                # the inbox drained above, so a submitted request has its id
                if b.cancel(creq.id):
                    moved = True
            if b.active or b.pending:
                moved = b.step() or moved
            # fan out completions (step() moved them to b.completed)
            while self._n_completed < len(b.completed):
                done = b.completed[self._n_completed]
                self._n_completed += 1
                tq = self._req_queues.pop(done.id, None)
                if tq is not None:
                    tq.put((_DONE, done))
            if not moved:
                self._wake.wait(timeout=0.02)
                self._wake.clear()

    def submit(self, prompt_ids: list[int], max_new_tokens: int, *,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int | None = None, logprobs: int = 0) -> queue.Queue:
        """Enqueue one request; returns the queue its tokens stream into
        (items: int token ids, then (_DONE, Request))."""
        tq: queue.Queue = queue.Queue()
        req = Request(
            prompt_ids=prompt_ids,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_p=top_p,
            seed=seed,
            logprobs=logprobs,
        )
        if logprobs:
            # _emit appends out_logprobs/out_top_logprobs BEFORE on_token
            # fires, so the latest entries belong to this token
            req.on_token = lambda t: tq.put(
                (t, req.out_logprobs[-1], req.out_top_logprobs[-1])
            )
        else:
            req.on_token = tq.put  # called from the scheduler thread
        self._inbox.put((req, tq))
        self._wake.set()

        def cancel():
            """Stop this request early (handler thread-safe: routed through
            the scheduler loop). The _DONE fan-out still arrives on tq."""
            self._cancels.put(req)
            self._wake.set()

        return tq, cancel

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)

def render_chat(messages: list[dict], chat_template: str | None) -> str:
    """Render an OpenAI-style messages list to a prompt string.

    Uses the checkpoint's own jinja chat template when the converter found
    one in tokenizer_config.json (carried in the container config);
    otherwise falls back to the Mistral-instruct [INST] convention (the
    flagship model family's format, reference README examples)."""
    if chat_template:
        import jinja2

        env = jinja2.Environment(keep_trailing_newline=True)

        def raise_exception(msg):
            raise jinja2.TemplateError(msg)

        tpl = env.from_string(chat_template)
        return tpl.render(
            messages=messages, add_generation_prompt=True,
            bos_token="", eos_token="</s>", raise_exception=raise_exception,
        )
    # fallback: [INST] blocks, system folded into the first user turn
    system = "\n".join(m["content"] for m in messages if m["role"] == "system")
    parts = []
    for m in messages:
        if m["role"] == "user":
            content = m["content"]
            if system:
                content = system + "\n\n" + content
                system = ""
            parts.append(f"[INST] {content} [/INST]")
        elif m["role"] == "assistant":
            parts.append(" " + m["content"])
    return "".join(parts)


def _consume(tok, tq, cancel, stops, ids):
    """Drain one request's queue to completion with server-side stop
    matching. Returns (out tokens, text, finish_reason, Request)."""
    req = None
    acc = ""
    starts = []  # char offset of each token's piece in acc
    toks_seen = []
    stop_idx = None
    prev2 = ids[-1] if ids else tok.bos_id
    while req is None:
        item = tq.get()
        if isinstance(item, tuple) and item[0] is _DONE:
            req = item[1]
            break
        if stop_idx is not None:
            continue  # draining until the cancel lands
        if isinstance(item, tuple):
            item = item[0]
        starts.append(len(acc))
        toks_seen.append(item)
        acc += tok.decode_one(prev2, item).decode("utf-8", "replace")
        prev2 = item
        if stops:
            hits = [i for i in (acc.find(s) for s in stops) if i >= 0]
            if hits:
                stop_idx = min(hits)
                cancel()
    if stop_idx is not None:
        # token-aligned views for the logprobs arrays: tokens whose pieces
        # begin before the stop match
        out = [t_ for t_, s_ in zip(toks_seen, starts) if s_ < stop_idx]
        return out, acc[:stop_idx], "stop", req
    out = req.out_tokens
    finish = "stop" if (out and tok.is_stop(out[-1])) else "length"
    if finish == "stop":
        out = out[:-1]
    return out, tok.decode(out), finish, req


def _top_dict(tok, prev: int, alts) -> dict:
    """Top-alternatives dict keyed by decoded piece, using the SAME
    previous-token context as the chosen token's piece so the chosen
    string is always present as a key. On text collisions (distinct ids
    decoding to the same piece) the HIGHEST logprob wins — alts arrive
    best-first, so first-wins keeps the max."""
    d: dict = {}
    for i_, lp_ in alts or []:
        k = tok.decode_one(prev, i_).decode("utf-8", "replace")
        if k not in d:
            d[k] = lp_
    return d


def _make_handler(srv: XalmServer):
    tok = srv.engine.tokenizer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(200, {
                    "object": "list",
                    "data": [{"id": srv.model_name, "object": "model",
                              "owned_by": "xalm_tpu_torch"}],
                })
            elif self.path == "/health":
                self._json(200, {"status": "ok", "active": srv.batcher.active,
                                 "pending": srv.batcher.pending})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            chat = self.path == "/v1/chat/completions"
            if self.path != "/v1/completions" and not chat:
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if chat:
                    prompt = render_chat(
                        body["messages"], getattr(srv.engine, "chat_template", None)
                    )
                else:
                    prompt = body.get("prompt", "")
                if isinstance(prompt, list):
                    prompt = "".join(prompt)
                max_tokens = int(body.get("max_tokens", 64))
                temperature = float(body.get("temperature", 0) or 0)
                top_p = float(body.get("top_p", 1) or 1)
                seed = body.get("seed")
                seed = int(seed) if seed is not None else None
                logprobs = int(body.get("logprobs", 0) or 0)
                if not 0 <= logprobs <= 5:
                    raise ValueError("logprobs must be between 0 and 5")
                if (temperature > 0 or (logprobs and not chat)) and \
                        srv.engine.sample_scan_rows is None:
                    raise ValueError(NO_ROW_SAMPLER)
                stops = body.get("stop") or []
                if isinstance(stops, str):
                    stops = [stops]
                stops = [str(s) for s in stops if s][:4]
                n_raw = body.get("n", 1)
                n_choices = int(1 if n_raw is None else n_raw)
                if not 1 <= n_choices <= 8:
                    raise ValueError("n must be between 1 and 8")
                if n_choices > 1 and body.get("stream"):
                    raise ValueError("n > 1 with stream is not supported")
                echo = bool(body.get("echo"))
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                self._json(400, {"error": {"message": f"bad request: {e}"}})
                return
            ids = tok.encode(prompt)
            tq, cancel = srv.submit(ids, max_tokens, temperature=temperature,
                                    top_p=top_p, seed=seed,
                                    logprobs=0 if chat else logprobs)
            hold = max((len(s) for s in stops), default=0)
            rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            obj = "chat.completion" if chat else "text_completion"

            def choice_piece(text, finish):
                if chat:
                    return {"index": 0, "delta": ({"content": text} if text
                                                  or not finish else {}),
                            "finish_reason": finish}
                return {"index": 0, "text": text, "finish_reason": finish}
            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj) -> None:
                    data = f"data: {json.dumps(obj)}\n\n".encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()

                def drain_after_cancel():
                    """Client went away mid-stream: stop the generation (it
                    would otherwise burn decode steps to max_tokens) and
                    absorb the queue through the _DONE fan-out."""
                    cancel()
                    while True:
                        it = tq.get()
                        if isinstance(it, tuple) and it[0] is _DONE:
                            return

                prev = ids[-1] if ids else tok.bos_id
                finish = "length"
                pend = []  # pieces held back: a stop string may span tokens
                acc = ""   # all generated text (emitted + held)
                n_emitted = 0  # chars of acc already emitted

                def send_piece(piece):
                    chunk({
                        "id": rid, "created": created,
                        "object": obj + ".chunk" if chat else obj,
                        "model": srv.model_name,
                        "choices": [piece],
                    })

                def flush(upto: int) -> None:
                    """Emit held pieces whose text lies before char ``upto``
                    of acc (trimming the piece that straddles it)."""
                    nonlocal n_emitted
                    while pend and n_emitted < upto:
                        p, start, text = pend[0]
                        if start >= upto:
                            break
                        cut = text[: upto - start]
                        if chat:
                            p["delta"] = {"content": cut}
                        else:
                            p["text"] = cut
                        send_piece(p)
                        n_emitted = start + len(cut)
                        if len(cut) < len(text):
                            break
                        pend.pop(0)

                stopped_early = False
                try:
                  while True:
                    item = tq.get()
                    if isinstance(item, tuple) and item[0] is _DONE:
                        req = item[1]
                        if stopped_early:
                            finish = "stop"
                        elif req.out_tokens and tok.is_stop(req.out_tokens[-1]):
                            finish = "stop"
                            flush(len(acc))
                        else:
                            flush(len(acc))
                        break
                    if stopped_early:
                        continue  # draining until the cancel lands
                    lp = top = None
                    if isinstance(item, tuple):
                        item, lp, top = item
                    text = tok.decode_one(prev, item).decode("utf-8", "replace")
                    piece = choice_piece(text, None)
                    if lp is not None and not chat:
                        piece["logprobs"] = {
                            "tokens": [text],
                            "token_logprobs": [lp],
                            "top_logprobs": [_top_dict(tok, prev, top)],
                        }
                    prev = item
                    pend.append((piece, len(acc), text))
                    acc += text
                    if stops:
                        hits = [i for i in (acc.find(s, max(n_emitted - hold, 0))
                                            for s in stops) if i >= 0]
                        if hits:
                            flush(min(hits))
                            cancel()
                            stopped_early = True
                            continue
                        flush(len(acc) - (hold - 1))
                    else:
                        flush(len(acc))
                  chunk({
                      "id": rid, "created": created,
                      "object": obj + ".chunk" if chat else obj,
                      "model": srv.model_name,
                      "choices": [choice_piece("", finish)],
                  })
                  data = b"data: [DONE]\n\n"
                  self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                  self.wfile.write(b"0\r\n\r\n")
                  self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    drain_after_cancel()
                return
            # non-streaming: consume to completion (stop sequences cancel
            # server-side as soon as they match). n > 1: the extra choices
            # were submitted with distinct seeds and generate concurrently
            # in the batcher; prefix caching makes their prefills cheap.
            extra = []
            for ci in range(1, n_choices):
                s_i = seed + ci if seed is not None else None
                extra.append(srv.submit(
                    ids, max_tokens, temperature=temperature, top_p=top_p,
                    seed=s_i, logprobs=0 if chat else logprobs,
                ))
            choices = []
            total_completion = 0
            for ci, (q_i, cancel_i) in enumerate([(tq, cancel)] + extra):
                out, text, finish, req = _consume(tok, q_i, cancel_i, stops, ids)
                total_completion += len(req.out_tokens)
                if echo and not chat:
                    text = prompt + text
                if chat:
                    choice = {"index": ci, "finish_reason": finish,
                              "message": {"role": "assistant", "content": text}}
                else:
                    choice = {"index": ci, "text": text, "finish_reason": finish}
                    if req.logprobs and req.out_logprobs:
                        n_lp = len(out)  # stop token (if trimmed) excluded
                        prev2 = ids[-1] if ids else tok.bos_id
                        pieces, tops = [], []
                        for t_, alts in zip(out, req.out_top_logprobs):
                            pieces.append(
                                tok.decode_one(prev2, t_).decode("utf-8", "replace")
                            )
                            tops.append(_top_dict(tok, prev2, alts))
                            prev2 = t_
                        choice["logprobs"] = {
                            "tokens": pieces,
                            "token_logprobs": req.out_logprobs[:n_lp],
                            "top_logprobs": tops,
                        }
                choices.append(choice)
            self._json(200, {
                "id": rid, "object": obj, "created": created,
                "model": srv.model_name,
                "choices": choices,
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": total_completion,
                          "total_tokens": len(ids) + total_completion},
            })

    return Handler


class Leader:
    """Rank 0's engine in a parallel server: each call that runs
    collectives (``MIRRORED``) is first broadcast to the other ranks, its
    name and host arguments (a cache as the handle of its creation), and
    they make the same call on their shards (``follow``). Every other
    attribute is the engine's own."""

    MIRRORED = ("step", "decode_scan", "new_cache", "copy_lane")

    def __init__(self, engine):
        self._engine = engine
        self._handles: dict[int, int] = {}  # id(cache) -> creation index

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name not in self.MIRRORED:
            return attr

        def call(*args, **kw):
            _send((name, [self._wire(a) for a in args],
                   {k: self._wire(v) for k, v in kw.items()}))
            out = attr(*args, **kw)
            if name == "new_cache":
                self._handles[id(out)] = len(self._handles)
            return out

        return call

    def _wire(self, v):
        return ("cache", self._handles[id(v)]) if id(v) in self._handles else v

    def stop(self) -> None:
        """Release the followers (``follow`` returns)."""
        _send(("stop", [], {}))


def _send(msg):
    import torch.distributed as dist

    box = [msg]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def follow(engine) -> None:
    """A parallel server's rank other than 0: make rank 0's engine calls
    (``Leader``) on this rank's shards until it stops."""
    caches = []
    while True:
        name, args, kw = _send(None)
        if name == "stop":
            return
        unwire = lambda v: caches[v[1]] if isinstance(v, tuple) and v[:1] == ("cache",) \
            else v  # noqa: E731
        out = getattr(engine, name)(*map(unwire, args), **{k: unwire(v) for k, v in kw.items()})
        if name == "new_cache":
            caches.append(out)


def serve(engine, host: str = "127.0.0.1", port: int = 8000,
          max_batch: int = 8, model_name: str = "xalm"):
    """Build (XalmServer, ThreadingHTTPServer) — caller runs serve_forever."""
    srv = XalmServer(engine, max_batch=max_batch, model_name=model_name)
    httpd = ThreadingHTTPServer((host, port), _make_handler(srv))
    return srv, httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="xalm-serve")
    ap.add_argument("checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--kv", default="auto", choices=["auto", "f16", "bf16", "f32", "i8"])
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ways")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ways (slots shard over dp)")
    ap.add_argument("--q4", type=int, default=0, metavar="GROUP",
                    help="pack the body weights to 4-bit at load (implies int8 activations; "
                         "single-device only)")
    ap.add_argument("-d", dest="device", default="cuda", choices=["cuda", "cpu"], help="device")
    args = ap.parse_args(argv)
    if args.q4 and args.tp * args.dp > 1:
        ap.error("--q4 is single-device (sharded engines stream i8)")

    import torch

    from xalm_tpu_torch.runtime.engine import Engine

    kv = {"auto": "auto", "f16": torch.float16, "bf16": torch.bfloat16,
          "f32": torch.float32, "i8": torch.int8}[args.kv]
    if args.tp * args.dp > 1:
        return _serve_parallel(args, kv, argv)
    eng = Engine.from_xalm(args.checkpoint, kv_dtype=kv, q4_group=args.q4, device=args.device)
    return _serve_until_interrupted(eng, args)


def _serve_until_interrupted(eng, args) -> int:
    srv, httpd = serve(eng, args.host, args.port, args.max_batch,
                       model_name=args.checkpoint.rsplit("/", 1)[-1])
    print(f"serving {args.checkpoint} on http://{args.host}:{httpd.server_address[1]}/v1 "
          f"(max_batch={args.max_batch}, "
          f"decode path: {eng.decode_path(args.max_batch)})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        httpd.server_close()
    return 0


def _serve_parallel(args, kv, argv) -> int:
    """--tp/--dp: a ShardedEngine over a (dp, tp) mesh. Rank 0 serves HTTP
    and runs the batcher; the other ranks follow its engine calls. Under
    torchrun or XALM_COORDINATOR this process is one rank; started plainly
    it starts the others (``multihost.spawn_ranks``) and is rank 0."""
    import sys

    import torch.distributed as dist

    from xalm_tpu_torch.parallel import multihost
    from xalm_tpu_torch.parallel.mesh import make_mesh
    from xalm_tpu_torch.parallel.sharded_engine import ShardedEngine

    ways = args.tp * args.dp
    children = [] if multihost.distributed_requested() else multihost.spawn_ranks(
        list(sys.argv[1:] if argv is None else argv), ways, "xalm_tpu_torch.serve.server")
    multihost.init_distributed(device="cpu" if args.device == "cpu" else None)
    rc = 0
    try:
        eng = ShardedEngine.from_xalm(args.checkpoint, make_mesh(dp=args.dp, tp=args.tp),
                                      kv_dtype=kv)
        if dist.get_rank() != 0:
            follow(eng)
        else:
            leader = Leader(eng)
            try:
                rc = _serve_until_interrupted(leader, args)
            finally:
                leader.stop()
    except BaseException:
        for p in children:  # they would wait for rank 0's next broadcast
            p.kill()
        raise
    finally:
        dist.destroy_process_group()
        if children and multihost.wait_ranks(children) != 0:
            print("error: a rank of the world failed", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
