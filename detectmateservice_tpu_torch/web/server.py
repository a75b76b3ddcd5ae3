"""Admin plane: the HTTP server behind the route table.

The port's copy of ``detectmateservice_tpu/web/server.py``: a stdlib
``ThreadingHTTPServer`` on a daemon thread, bound to ``http_host`` and
``http_port`` (0 binds an ephemeral port, which ``port`` names), with JSON
encoding and error mapping around ``web/router.py``'s handlers; an unknown
route answers 404.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .router import Response, route_table


class WebServer:
    def __init__(self, service) -> None:
        self.service = service
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    @property
    def port(self) -> int:
        """The bound port (the settings' port before ``start``)."""
        with self._lock:
            if self._httpd is not None:
                return self._httpd.server_address[1]
        return self.service.settings.http_port

    def start(self) -> None:
        with self._lock:
            if self._httpd is not None:
                return
            self._httpd = ThreadingHTTPServer(
                (self.service.settings.http_host, self.service.settings.http_port),
                _make_handler(self.service))
            self._httpd.daemon_threads = True
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            name="WebServerThread", daemon=True,
                                            kwargs={"poll_interval": 0.1})
            self._thread.start()

    def stop(self) -> None:
        # swap the references out under the lock, block outside it
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if thread is not None:
            thread.join(timeout=2.0)


def _make_handler(service):
    table = route_table()

    class AdminHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args) -> None:
            logging.getLogger("web").debug("%s " + fmt, self.client_address[0], *args)

        def _send(self, code: int, body: bytes, content_type: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, payload: Any) -> None:
            self._send(code, json.dumps(payload).encode("utf-8"))

        def _read_json(self) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
            length = int(self.headers.get("Content-Length") or 0)
            if length == 0:
                return {}, None
            try:
                return json.loads(self.rfile.read(length) or b"{}"), None
            except json.JSONDecodeError as exc:
                return None, str(exc)

        def _dispatch(self, method: str, payload: Optional[Dict[str, Any]]) -> None:
            parsed = urlparse(self.path)
            route = table.get((method, parsed.path))
            if route is None:
                self._send_json(404, {"detail": "not found"})
                return
            try:
                response: Response = route.handler(service, parse_qs(parsed.query), payload)
            except ValueError as exc:       # bad parameters: a client error
                self._send_json(400, {"detail": str(exc)})
                return
            except Exception as exc:  # noqa: BLE001 — admin errors surface as 500s
                try:
                    self._send_json(500, {"detail": str(exc)})
                except (BrokenPipeError, ConnectionResetError):
                    pass
                return
            body = response.body
            if isinstance(body, (bytes, bytearray)):
                self._send(response.status, bytes(body), response.content_type)
            else:
                self._send_json(response.status, body)
            if response.after is not None:
                response.after()

        def do_GET(self) -> None:
            self._dispatch("GET", None)

        def do_POST(self) -> None:
            payload, err = self._read_json()
            if err is not None:
                self._send_json(400, {"detail": f"invalid JSON: {err}"})
                return
            self._dispatch("POST", payload)

    return AdminHandler
