"""Open-loop HTTP client: sends each request at its due time, whatever is
still outstanding, one request per connection (HTTP/1.0), each in one write
with TCP_NODELAY, and reports every request's times and answer.

Runs as its own process, so that it takes no interpreter time from the
server. Input (stdin, JSON): host, port, t0 (the window's start on the
monotonic clock that ``time.perf_counter`` reads), dues (s after t0),
files (the JPEG sent by each request), wait_s (how long past the last due
an answer may take). Output (stdout, JSON lines): i, due, sent, done (the
same clock), status, port (the client's, which names the request on the
server's side), body (the JSON answer) or error."""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor


def request(host, port, body: bytes, timeout: float):
    s = socket.create_connection((host, port), timeout=timeout)
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        local = s.getsockname()[1]
        head = (f"POST /predict HTTP/1.0\r\nHost: {host}\r\nContent-Type: image/jpeg\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode()
        s.sendall(head + body)
        chunks = []
        while True:
            c = s.recv(65536)
            if not c:
                break
            chunks.append(c)
    finally:
        s.close()
    raw = b"".join(chunks)
    head, _, payload = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1]) if head else 0
    return status, local, payload


def main() -> int:
    spec = json.load(sys.stdin)
    bodies = {}
    for f in set(spec["files"]):
        with open(f, "rb") as fh:
            bodies[f] = fh.read()
    t0, dues, files = spec["t0"], spec["dues"], spec["files"]
    deadline = t0 + dues[-1] + spec["wait_s"]
    out, lock = [], threading.Lock()

    def one(i):
        sent = time.perf_counter()
        rec = {"i": i, "due": t0 + dues[i], "sent": sent}
        try:
            status, local, payload = request(spec["host"], spec["port"], bodies[files[i]],
                                             max(1.0, deadline - sent))
            rec.update(done=time.perf_counter(), status=status, port=local,
                       body=json.loads(payload) if status == 200 else payload.decode()[:200])
        except (OSError, ValueError) as e:
            rec.update(done=None, status=0, error=f"{type(e).__name__}: {e}")
        with lock:
            out.append(rec)

    with ThreadPoolExecutor(max_workers=spec.get("clients", 256)) as pool:
        futures = []
        for i, d in enumerate(dues):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(one, i))
        for f in futures:
            f.result()
    for rec in sorted(out, key=lambda r: r["i"]):
        sys.stdout.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
