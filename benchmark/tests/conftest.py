"""CPU tests of the benchmark: ``python -m pytest benchmark/tests -q``.

Tests that need the card carry the ``cuda`` marker and look for it inside
a fixture (``card``), never while a module is imported.
"""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=4, max_seq_len=128)


def tiny_cell(name: str, **model):
    """A cell of BENCHMARK.json cut to a CPU test's size: the same family,
    block and deployment at hidden 64, 2 layers, 128 positions, with its
    mix's lengths cut to fit."""
    from harness import spec

    c = spec.load_cell(ROOT, name)
    conf = copy.deepcopy(c.config)
    conf["model"].update(TINY, **model)
    conf["deployment"]["max_seq_len"] = TINY["max_seq_len"]
    mix = copy.deepcopy(c.mix)
    mix["sampling"]["greedy_share"] = 1.0  # every finished request compared in a short run
    if mix["loop"] == "chat":
        mix.update(first_turn_tokens={"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8,
                                      "max": 48},
                   user_turn_tokens={"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 2,
                                     "max": 16},
                   answer_tokens={"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 2,
                                  "max": 24},
                   max_window=128, mean_gen=16, max_gen=32, pool_sessions=8)
    else:
        mix.update(prompt_tokens={"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 4,
                                  "max": 64},
                   output_tokens={"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 2,
                                  "max": 24},
                   rate_rps=4.0, preroll_s=0.5, tail_s=2.0)
    return spec.Cell(c.name, ROOT, c.bench, c.workload, conf, mix, c.end_to_end, c.per_layer)


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """The runs drive the tiny model from one host thread, as run.py drives
    the card: an intra-op pool on a shared, busy machine stalls an open
    loop for seconds and a short window then finishes nothing."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (cuda marker)")
    return torch.device("cuda:0")
