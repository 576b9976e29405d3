"""The port's wire server and serve entry point, on the CPU.

SchedulerServer + RemoteScheduler on 127.0.0.1 (port 0): requests stream
back the tokens that the in-process scheduler gives for them, and a
cancel mid-generation frees the slot (tests/test_coordinator.py's wire
tests on the port). The serve entry point runs as two real processes.
"""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.models import get_config, init_random_params
from mlc_llm_tpu_torch.parallel.wire import RemoteScheduler, SchedulerServer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engine():
    cfg = get_config("tiny-llama")
    return InferenceEngine(cfg, init_random_params(cfg, "f32", seed=0, device="cpu"),
                           max_batch=2, max_seq_len=64, kv_layout="paged", page_size=8,
                           device="cpu")


def _greedy(n):
    return GenerationConfig(max_new_tokens=n, temperature=0.0)


def test_wire_streams_the_in_process_tokens(engine):
    prompts = [[1, 2, 3], [9, 8], [4, 5, 6, 7]]
    local = ContinuousBatchingScheduler(engine)
    want = [local.submit(p, _greedy(5)) for p in prompts]
    local.run()
    server = SchedulerServer(ContinuousBatchingScheduler(engine)).start()
    try:
        client = RemoteScheduler(("127.0.0.1", server.port))
        streamed = {i: [] for i in range(len(prompts))}
        reqs = [client.submit(p, _greedy(5), on_token=streamed[i].append)
                for i, p in enumerate(prompts)]
        assert client.wait_all(60), "requests did not complete over the wire"
        for i, (r, w) in enumerate(zip(reqs, want)):
            assert r.output == w.output == streamed[i]  # per-token pushes
        assert client.load() == 0
        st = client.stats()
        assert st["decode_tokens"] > 0 and st["decode_time"] > 0
        client.close()
    finally:
        server.stop()
    assert server.error is None


def test_wire_cancel_mid_generation_frees_the_slot(engine):
    sched = ContinuousBatchingScheduler(engine)
    server = SchedulerServer(sched).start()
    try:
        client = RemoteScheduler(("127.0.0.1", server.port))
        got = []
        req = client.submit([1, 2, 3], GenerationConfig(max_new_tokens=100_000,
                                                        temperature=0.0),
                            on_token=got.append)
        deadline = time.time() + 60
        while not got and time.time() < deadline:
            time.sleep(0.01)
        assert got, "no tokens before cancel"
        client.cancel(req)
        assert req.wait(30), "cancel did not resolve the request"
        assert req.done and len(req.output) < 100_000
        assert client.load() == 0  # the slot is free server-side
        assert engine.allocator.free_pages == engine.num_pages - 1  # and its pages
        client.close()
    finally:
        server.stop()


def test_serve_entrypoint_end_to_end():
    """`python -m mlc_llm_tpu_torch.serve --device cpu --paged` and a
    `--connect` client, as two processes."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = subprocess.Popen(
        [sys.executable, "-m", "mlc_llm_tpu_torch.serve", "--model", "tiny-llama",
         "--random-weights", "--device", "cpu", "--paged", "--max-batch", "2",
         "--max-seq-len", "64", "--page-size", "16", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    try:
        deadline = time.time() + 120
        up = False
        while time.time() < deadline and srv.poll() is None:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                up = True
                break
            except OSError:
                time.sleep(0.2)
        assert up, f"server never came up (rc={srv.poll()})"
        out = subprocess.run(
            [sys.executable, "-m", "mlc_llm_tpu_torch.serve", "--connect",
             f"127.0.0.1:{port}", "--prompt-ids", "1,2,3", "--temperature", "0",
             "--max-gen-len", "4"],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert out.returncode == 0, out.stdout + out.stderr
        toks = [int(x) for x in out.stdout.split()]
        assert 1 <= len(toks) <= 4
        assert "done" in out.stderr
    finally:
        srv.kill()  # the exact process we started
        srv.wait()
