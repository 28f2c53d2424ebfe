"""Thin stdlib HTTP front end over :class:`repro_torch.serve.server.Server`.

JSON over ``http.server.ThreadingHTTPServer`` — no web framework, so
the serving layer stays import-clean in the baked container.  Routes:

====== ==================================  =================================
GET    /healthz                            liveness probe
GET    /metrics                            ``Server.stats()`` snapshot
POST   /v1/sessions/{sid}                  admit a graph
POST   /v1/sessions/{sid}/edges            push an edge batch
GET    /v1/sessions/{sid}/labels           stable-id cluster assignment
GET    /v1/sessions/{sid}                  last committed session summary
DELETE /v1/sessions/{sid}                  evict
====== ==================================  =================================

Error mapping is the typed-error satellite made visible on the wire:
:class:`~repro_torch.stream.service.UnknownSessionError` -> **404**,
``ValueError`` (malformed batch / bad mode / duplicate admit) -> **400**,
anything else -> **500** with the exception text in the JSON body.

Request threads are the ThreadingHTTPServer pool; they only ever stage
pushes and read the versioned results store, so the engine thread keeps
exclusive ownership of device work.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from repro_torch.serve.server import Server
from repro_torch.stream.service import UnknownSessionError


def _jsonable(obj):
    """Recursively coerce numpy scalars/arrays and torch tensors (moved
    to the host first) into JSON-native types."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    return obj


class _Handler(BaseHTTPRequestHandler):
    # the bound Server instance; set by make_http_server on the subclass
    server_obj: Server = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # keep stdout for the shell banner
        pass

    # -- plumbing ------------------------------------------------------

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(_jsonable(payload)).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length == 0:
            return {}
        data = json.loads(self.rfile.read(length).decode())
        if not isinstance(data, dict):
            raise ValueError("request body must be a JSON object")
        return data

    def _dispatch(self, method: str) -> None:
        try:
            handled = self._route(method)
        except UnknownSessionError as e:
            self._reply(404, {"error": str(e)})
            return
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # surface, don't kill the worker thread
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if not handled:
            self._reply(404, {"error": f"no route {method} {self.path}"})

    def _route(self, method: str) -> bool:
        srv = self.server_obj
        path = self.path.split("?", 1)[0].rstrip("/")
        if method == "GET" and path == "/healthz":
            self._reply(200, {"ok": True, "running": srv.running})
            return True
        if method == "GET" and path == "/metrics":
            self._reply(200, srv.stats())
            return True
        parts = [p for p in path.split("/") if p]
        if len(parts) < 2 or parts[0] != "v1" or parts[1] != "sessions":
            return False
        if len(parts) < 3:
            return False
        sid = parts[2]
        tail = parts[3] if len(parts) > 3 else None
        if tail is None:
            if method in ("POST", "PUT"):
                body = self._body()
                for req in ("edges", "num_nodes"):
                    if req not in body:
                        raise ValueError(f"admit requires {req!r}")
                out = srv.admit(
                    sid, body["edges"], int(body["num_nodes"]),
                    weights=body.get("weights"),
                    num_clusters=body.get("num_clusters"),
                    edge_capacity=body.get("edge_capacity"))
                self._reply(200, out)
                return True
            if method == "GET":
                self._reply(200, srv.summary(sid))
                return True
            if method == "DELETE":
                out = dict(srv.evict(sid))
                out.pop("panel", None)  # not JSON-friendly at scale
                self._reply(200, out)
                return True
            return False
        if tail == "edges" and method == "POST":
            body = self._body()
            for req in ("edges", "weights"):
                if req not in body:
                    raise ValueError(f"push requires {req!r}")
            out = srv.push(sid, body["edges"], body["weights"],
                           mode=body.get("mode", "set"))
            self._reply(200, out)
            return True
        if tail == "labels" and method == "GET":
            self._reply(200, srv.labels(sid))
            return True
        return False

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_DELETE(self):
        self._dispatch("DELETE")


class ServeHTTP:
    """Owns the listening socket + acceptor thread over a ``Server``."""

    def __init__(self, server: Server, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = server
        handler = type("BoundHandler", (_Handler,), {"server_obj": server})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "ServeHTTP":
        if not self.app.running:
            self.app.start()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="serve-http",
            kwargs={"poll_interval": 0.1}, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Clean shutdown: stop accepting, then drain the engine."""
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.httpd.server_close()
        self.app.stop()

    def __enter__(self) -> "ServeHTTP":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ServeHTTP"]
