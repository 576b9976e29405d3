"""Cross-host request wire: a TCP/JSON-lines front door per host.

The counterpart of ``mlc_llm_tpu/parallel/wire.py``, the same protocol,
serving the port's ContinuousBatchingScheduler. The protocol carries
REQUESTS and TOKENS, never tensors:

  client                                  server
  RemoteScheduler.submit ──"submit"──▶    SchedulerServer
                         ◀─"token"*──     (drives its local
                         ◀─"done"───       ContinuousBatchingScheduler
  RemoteScheduler.load   ──"load"──▶       in a background thread)
                         ◀─"load"───

Protocol: one JSON object per line, UTF-8.
  client -> server:
    {"type": "submit", "id": <client id>, "prompt": [ints],
     "gen": {GenerationConfig fields}}
    {"type": "cancel", "id"}    -> stop generating; a "done" with the
                                   tokens produced so far comes back
    {"type": "load", "id"}      -> queue depth (for least-loaded routing)
    {"type": "stats", "id"}     -> engine throughput counters
  server -> client:
    {"type": "token", "id", "token"}         (one per generated token)
    {"type": "done", "id", "output": [ints]} (terminal)
    {"type": "load", "id", "load": int}
    {"type": "stats", "id", "prefill_tokens": .., "prefill_time": ..,
     "decode_tokens": .., "decode_time": ..}

The server drives its scheduler on ONE thread (the scheduler and the
engine's cache are not thread-safe); socket reads run on per-connection
threads that only enqueue work under a lock.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

from ..engine.engine import GenerationConfig
from ..engine.scheduler import ContinuousBatchingScheduler


def _gen_to_dict(gen: GenerationConfig) -> dict:
    d = dataclasses.asdict(gen)
    d["stop_tokens"] = list(d["stop_tokens"])
    return d


def _gen_from_dict(d: dict) -> GenerationConfig:
    d = dict(d)
    d["stop_tokens"] = tuple(d.get("stop_tokens", ()))
    return GenerationConfig(**d)


class _Conn:
    """A socket with line framing and a write lock (token pushes and
    request replies come from different threads)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rfile = sock.makefile("rb")
        self._wlock = threading.Lock()

    def send(self, msg: dict) -> None:
        data = (json.dumps(msg) + "\n").encode()
        with self._wlock:
            self.sock.sendall(data)

    def recv(self) -> Optional[dict]:
        line = self.rfile.readline()
        if not line:
            return None
        return json.loads(line)

    def close(self) -> None:
        # shutdown first: it wakes a reader blocked in recv on another
        # thread, which close alone does not
        for fn in (lambda: self.sock.shutdown(socket.SHUT_RDWR), self.sock.close):
            try:
                fn()
            except OSError:
                pass


class SchedulerServer:
    """Serves one host's ContinuousBatchingScheduler over TCP.

    The scheduler is driven by a dedicated background thread; submit
    messages enqueue into the scheduler under a lock (scheduler.submit
    only appends to a deque), and completion/token events are pushed
    back over the submitting connection. stop() ends and joins every
    thread the server started and closes its sockets.
    """

    def __init__(
        self,
        scheduler: ContinuousBatchingScheduler,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.scheduler = scheduler
        self._lsock = socket.create_server((host, port))
        self.address: Tuple[str, int] = self._lsock.getsockname()[:2]
        self.port = self.address[1]
        self._stop = threading.Event()
        self._lock = threading.Lock()  # guards scheduler mutation
        # live requests: req-object -> (conn, client id, #tokens pushed)
        self._live: Dict[int, tuple] = {}
        self._threads: List[threading.Thread] = []
        self._conns: List[_Conn] = []
        self.completed = 0  # requests finished over this server's lifetime
        self.error: Optional[str] = None  # traceback that stopped the drive loop

    # --------------------------------------------------------------- lifecycle
    def start(self) -> "SchedulerServer":
        for fn in (self._accept_loop, self._drive_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        # shutdown wakes the accept loop, which close alone does not
        for fn in (lambda: self._lsock.shutdown(socket.SHUT_RDWR), self._lsock.close):
            try:
                fn()
            except OSError:
                pass
        for conn in list(self._conns):
            conn.close()  # unblocks the per-connection readers
        for t in self._threads:
            t.join(timeout=5)

    # ------------------------------------------------------------------ loops
    def _drive_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                try:
                    busy = self.scheduler.has_work()
                    if busy:
                        self.scheduler.step()
                    self._flush_done()
                except Exception:
                    # the server's boundary: keep the traceback for the
                    # operator and stop driving (requests stay unfinished)
                    self.error = traceback.format_exc()
                    return
            if not busy:
                time.sleep(0.002)

    def _flush_done(self) -> None:
        """Send terminal messages for finished requests (under _lock)."""
        for key in list(self._live):
            req, conn, rid = self._live[key]
            if req.done:
                del self._live[key]
                self.completed += 1
                try:
                    conn.send({"type": "done", "id": rid,
                               "output": list(req.output)})
                except OSError:
                    pass  # client went away; request already finished

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._lsock.accept()
            except OSError:
                return  # listener closed
            conn = _Conn(sock)
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: _Conn) -> None:
        while not self._stop.is_set():
            try:
                msg = conn.recv()
            except (OSError, ValueError):
                break
            if msg is None:
                break
            mtype = msg.get("type")
            if mtype == "submit":
                rid = msg["id"]

                def on_token(tok: int, _rid=rid, _conn=conn) -> None:
                    # runs on the drive thread inside scheduler.step
                    try:
                        _conn.send({"type": "token", "id": _rid,
                                    "token": int(tok)})
                    except OSError:
                        pass

                gen = _gen_from_dict(msg.get("gen", {}))
                with self._lock:
                    req = self.scheduler.submit(
                        [int(t) for t in msg["prompt"]], gen,
                        on_token=on_token,
                    )
                    self._live[id(req)] = (req, conn, rid)
            elif mtype == "cancel":
                rid = msg["id"]
                with self._lock:
                    for key, (req, _conn, req_rid) in list(
                            self._live.items()):
                        if req_rid == rid and _conn is conn:
                            self.scheduler.cancel(req)
                            # _flush_done sends the terminal message on
                            # the drive thread (req.done is now set)
                            break
            elif mtype == "load":
                with self._lock:
                    load = (len(self.scheduler.pending)
                            + self.scheduler.num_active)
                conn.send({"type": "load", "id": msg.get("id"), "load": load})
            elif mtype == "stats":
                st = self.scheduler.engine.stats
                conn.send({
                    "type": "stats", "id": msg.get("id"),
                    "prefill_tokens": st.prefill_tokens,
                    "prefill_time": st.prefill_time,
                    "decode_tokens": st.decode_tokens,
                    "decode_time": st.decode_time,
                })
            else:
                conn.send({"type": "error", "id": msg.get("id"),
                           "error": f"unknown type {mtype!r}"})
        conn.close()


@dataclasses.dataclass
class RemoteRequest:
    """Client-side view of a request running on another host."""

    id: int
    prompt: List[int]
    gen: GenerationConfig
    on_token: Optional[Callable[[int], None]] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None  # set when the connection died mid-flight
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class RemoteScheduler:
    """Client to a SchedulerServer; drop-in peer of a local scheduler in
    HostCoordinator (submit / has_work / load / stats)."""

    def __init__(self, address: Tuple[str, int], timeout: float = 30.0):
        self._conn = _Conn(socket.create_connection(address, timeout=timeout))
        self.timeout = timeout
        self._reqs: Dict[int, RemoteRequest] = {}
        self._replies: Dict[int, dict] = {}
        self._reply_evt: Dict[int, threading.Event] = {}
        self._ids = iter(range(1, 1 << 62))
        self._lock = threading.Lock()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # ------------------------------------------------------------------ wire
    def _read_loop(self) -> None:
        while True:
            try:
                msg = self._conn.recv()
            except (OSError, ValueError):
                msg = None
            if msg is None:
                # connection closed: FAIL every outstanding request (so
                # done flips and has_work() drains — a dead server must
                # not leave the coordinator spinning) and release every
                # reply waiter (they'll see the missing reply and raise
                # ConnectionError)
                with self._lock:
                    reqs = list(self._reqs.values())
                    self._reqs.clear()
                    evts = list(self._reply_evt.values())
                for req in reqs:
                    req.error = "connection lost"
                    req.done = True
                    req._event.set()
                for evt in evts:
                    evt.set()
                return
            try:
                self._dispatch(msg)
            except Exception:
                # a throwing user on_token callback must not kill the
                # reader thread (that would hang every other request)
                pass

    def _dispatch(self, msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == "token":
            req = self._reqs.get(msg["id"])
            if req is not None:
                req.output.append(int(msg["token"]))
                if req.on_token is not None:
                    req.on_token(int(msg["token"]))
        elif mtype == "done":
            with self._lock:
                req = self._reqs.pop(msg["id"], None)
            if req is not None:
                req.output[:] = [int(t) for t in msg["output"]]
                req.done = True
                req._event.set()
        else:  # load / stats / error replies
            with self._lock:
                rid = msg.get("id")
                self._replies[rid] = msg
                evt = self._reply_evt.get(rid)
            if evt is not None:
                evt.set()

    def _request_reply(self, msg: dict) -> dict:
        rid = next(self._ids)
        evt = threading.Event()
        with self._lock:
            self._reply_evt[rid] = evt
        self._conn.send({**msg, "id": rid})
        if not evt.wait(self.timeout):
            raise TimeoutError(f"no reply to {msg['type']} within "
                               f"{self.timeout}s")
        with self._lock:
            del self._reply_evt[rid]
            reply = self._replies.pop(rid, None)
        if reply is None:
            # the event was set by the disconnect path, not a reply
            raise ConnectionError(
                f"connection lost waiting for {msg['type']} reply")
        return reply

    # ------------------------------------------------------------------- API
    def submit(
        self,
        prompt: List[int],
        gen: GenerationConfig = GenerationConfig(),
        on_token=None,
    ) -> RemoteRequest:
        rid = next(self._ids)
        req = RemoteRequest(id=rid, prompt=list(prompt), gen=gen,
                            on_token=on_token)
        with self._lock:
            self._reqs[rid] = req
        self._conn.send({
            "type": "submit", "id": rid,
            "prompt": [int(t) for t in prompt],
            "gen": _gen_to_dict(gen),
        })
        return req

    def cancel(self, req: RemoteRequest) -> None:
        """Ask the server to stop generating req; its terminal "done"
        message (with the tokens produced so far) resolves the handle."""
        self._conn.send({"type": "cancel", "id": req.id})

    def load(self) -> int:
        return int(self._request_reply({"type": "load"})["load"])

    def stats(self) -> dict:
        return self._request_reply({"type": "stats"})

    def has_work(self) -> bool:
        """Outstanding requests submitted THROUGH THIS CLIENT (the
        remote host drives its own loop; the coordinator only needs to
        know whether to keep waiting)."""
        with self._lock:
            return bool(self._reqs)

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            reqs = list(self._reqs.values())
        deadline = None if timeout is None else time.monotonic() + timeout
        for r in reqs:
            left = None if deadline is None else deadline - time.monotonic()
            if not r.wait(left):
                return False
        return True

    def close(self) -> None:
        self._conn.close()
