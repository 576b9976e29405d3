"""The port's host coordinator (``parallel/coordinator.py``) and each
process's slot range (``parallel/multihost.py``), the coordinator cases of
tests/test_coordinator.py on the port: routing and completion, least-loaded
routing, the single-process local scheduler, a local and a remote host
mixed, the stats text. Every request's greedy tokens equal the JAX
coordinator's on the same tiny f32 parameters (tests/test_coordinator.py's
seed), carried across with models/convert.py.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mlc_llm_tpu.engine import GenerationConfig as JGen
from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.engine.scheduler import ContinuousBatchingScheduler as JSched
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.parallel.coordinator import HostCoordinator as JCoordinator
from mlc_llm_tpu.parallel.multihost import process_local_slots as jprocess_local_slots
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.models import get_config
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.parallel.coordinator import HostCoordinator, local_scheduler
from mlc_llm_tpu_torch.parallel.multihost import process_local_slots

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jparams():
    return jinit(jget_config("tiny-llama"), "f32", seed=0)


@pytest.fixture(scope="module")
def hosts(jparams):
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return [InferenceEngine(get_config("tiny-llama"), params, max_batch=2, max_seq_len=64,
                            device="cpu") for _ in range(2)]


def _greedy(n):
    return GenerationConfig(max_new_tokens=n, temperature=0.0)


ROUTED = [[i + 1, i + 2, i + 3] for i in range(6)]
MIXED = [[i + 1, i + 2] for i in range(4)]


@pytest.fixture(scope="module")
def jax_streams(jparams):
    """The JAX coordinator's greedy streams over two JAX hosts: ROUTED at
    5 new tokens, MIXED at 4."""
    cfg = jget_config("tiny-llama")
    engines = [JEngine(cfg, jparams, max_batch=2, max_seq_len=64) for _ in range(2)]
    out = {}
    for prompts, n in ((ROUTED, 5), (MIXED, 4)):
        coord = JCoordinator([JSched(e, seed=i) for i, e in enumerate(engines)])
        reqs = coord.submit_many(prompts, JGen(max_new_tokens=n, temperature=0.0))
        coord.run()
        out[n] = [r.output for r in reqs]
    return out


def test_coordinator_routes_and_completes(hosts, jax_streams):
    scheds = [ContinuousBatchingScheduler(e, seed=i) for i, e in enumerate(hosts)]
    coord = HostCoordinator(scheds)
    prompts = ROUTED
    reqs = coord.submit_many(prompts, _greedy(5))
    coord.run()
    assert all(r.done for r in reqs)
    # outputs match solo runs regardless of which host served them, and JAX's
    for p, r in zip(prompts, reqs):
        assert r.output == hosts[0].generate([p], _greedy(5))[0]
    assert [r.output for r in reqs] == jax_streams[5]
    served = [s.engine.stats.decode_tokens for s in scheds]
    assert all(v > 0 for v in served), served  # least-loaded: both hosts served
    assert "aggregate" in coord.stats_text()


def test_coordinator_least_loaded_routing(hosts):
    scheds = [ContinuousBatchingScheduler(e) for e in hosts]
    coord = HostCoordinator(scheds)
    for _ in range(3):  # host 0 has pending work: the next submit goes to host 1
        scheds[0].submit([1, 2], _greedy(2))
    r = coord.submit([3, 4], _greedy(2))
    assert r in scheds[1].pending
    coord.run()
    assert r.done and not coord.has_work()


def test_local_scheduler_single_process(hosts):
    sched = local_scheduler(hosts[0])
    assert sched.slots == list(range(hosts[0].max_batch))
    req = sched.submit([5, 6], _greedy(3))
    sched.run()
    assert req.done and req.output == hosts[0].generate([[5, 6]], _greedy(3))[0]


def test_coordinator_mixes_local_and_remote(hosts, jax_streams):
    from mlc_llm_tpu_torch.parallel.wire import RemoteScheduler, SchedulerServer

    server = SchedulerServer(ContinuousBatchingScheduler(hosts[1])).start()
    try:
        local = ContinuousBatchingScheduler(hosts[0])
        remote = RemoteScheduler(("127.0.0.1", server.port))
        coord = HostCoordinator([local, remote])
        prompts = MIXED
        reqs = coord.submit_many(prompts, _greedy(4))
        coord.run()
        assert all(r.done for r in reqs)
        assert [r.output for r in reqs] == [hosts[0].generate([p], _greedy(4))[0]
                                            for p in prompts]
        assert [r.output for r in reqs] == jax_streams[4]
        st = coord.stats_text()
        assert "host0" in st and "host1" in st and "aggregate" in st
        assert coord.aggregate_throughput() is not None
        remote.close()
    finally:
        server.stop()


def test_stats_text_before_and_after_decode(hosts):
    # no decode yet: "aggregate: n/a"; after one, every host's line and the
    # aggregate over the slowest host's decode time
    fresh = [InferenceEngine(e.cfg, e.params, max_batch=2, max_seq_len=64, device="cpu")
             for e in hosts]
    coord = HostCoordinator([ContinuousBatchingScheduler(e) for e in fresh])
    assert coord.aggregate_throughput() is None
    assert coord.stats_text().splitlines() == [
        "host0: encode: 0.0 tok/s, decode: 0.0 tok/s",
        "host1: encode: 0.0 tok/s, decode: 0.0 tok/s", "aggregate: n/a"]
    coord.submit_many([[1, 2, 3], [4, 5]], _greedy(3))
    coord.run()
    stats = [coord._host_stats(s) for s in coord.schedulers]
    want = sum(s["decode_tokens"] for s in stats) / max(s["decode_time"] for s in stats)
    assert coord.aggregate_throughput(stats) == pytest.approx(want)
    assert coord.stats_text().splitlines()[-1].startswith("aggregate decode: ")
    with pytest.raises(ValueError):
        HostCoordinator([])


@pytest.mark.parametrize("total", [1, 2, 5, 8])
def test_process_local_slots_single_process(total):
    assert process_local_slots(total) == jprocess_local_slots(total) == range(total)


def test_process_local_slots_reads_the_process_group():
    # two processes in one gloo group over localhost: rank 0 takes the
    # first half of 5 slots, rank 1 the rest (JAX's split by process index)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = (
        "import sys, torch.distributed as dist\n"
        "from mlc_llm_tpu_torch.parallel.multihost import process_local_slots\n"
        f"dist.init_process_group('gloo', init_method='tcp://127.0.0.1:{port}',\n"
        "                        world_size=2, rank=int(sys.argv[1]))\n"
        "r = process_local_slots(5)\n"
        "dist.destroy_process_group()\n"
        "print(r.start, r.stop)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.split() for o, _ in outs] == [["0", "2"], ["2", "5"]]
