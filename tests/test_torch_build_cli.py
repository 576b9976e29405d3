"""The port's build driver, CLI and server on checkpoints, on the CPU.

- build --random, then the CLI one-shot with --weights;
- the CLI's --speculative: the same reply as the plain loop;
- the CLI's dist/<model>* artifact search, and its skip of a candidate
  built with another quantization;
- the port's engine on a checkpoint that the JAX package's build wrote:
  its greedy tokens equal the JAX engine's on the same directory (held as
  tests/test_torch_model.py holds them: on this model and prompt the
  top-1/top-2 logit gap stays >= 8.5e-3 over the 12 tokens, far above
  float noise);
- serve --weights answers a request over the wire;
- full_version().
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mlc_llm_tpu import build as jbuild
from mlc_llm_tpu.engine import GenerationConfig as JGen
from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.utils.checkpoint import load_params as jload
from mlc_llm_tpu_torch import build, cli
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.models import get_config, init_random_params
from mlc_llm_tpu_torch.utils.checkpoint import load_params
from mlc_llm_tpu_torch.version import full_version

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _build(out, quant="q4bf16"):
    build.main(["--model", "tiny-llama", "--random", "--quantization", quant, "-o", str(out),
                "--device", "cpu"])


def test_build_random_then_cli(tmp_path, capsys):
    out = tmp_path / "ck"
    _build(out)
    loaded, meta = load_params(str(out), device="cpu")
    assert meta == {"model": "tiny-llama", "quantization": "q4bf16", "max_seq_len": 128,
                    "built_with": "mlc_llm_tpu_torch.build"}
    want = init_random_params(get_config("tiny-llama"), "q4bf16", seed=0, device="cpu")
    assert torch.equal(loaded["layers"]["w_in"].data, want["layers"]["w_in"].data)
    assert (out / "build_config.json").is_file()
    capsys.readouterr()
    cli.main(["--model", "tiny-llama", "--weights", str(out), "--prompt", "Hey",
              "--max-gen-len", "3", "--temperature", "0", "--seed", "1",
              "--max-window-size", "256", "--device", "cpu"])
    got = capsys.readouterr()
    assert got.out.endswith("\n") and "decode:" in got.err


def test_cli_speculative_prints_the_plain_reply(capsys, monkeypatch):
    """--speculative 4 on a greedy one-shot: the turn rides speculation
    (the verify program runs) and prints the reply of the plain loop."""
    from mlc_llm_tpu_torch.engine import session as session_mod

    monkeypatch.setenv("MLC_SPEC_FORCE", "1")
    streams = []
    stream = session_mod.speculative_stream

    def counted(engine, *a, **kw):
        streams.append(engine)
        return stream(engine, *a, **kw)

    monkeypatch.setattr(session_mod, "speculative_stream", counted)
    argv = ["--model", "tiny-llama", "--random-weights", "--prompt", "hi", "--temperature", "0",
            "--max-gen-len", "12", "--max-window-size", "64", "--device", "cpu"]
    replies = []
    for extra in ([], ["--speculative", "4"]):
        capsys.readouterr()
        cli.main(argv + extra)
        replies.append(capsys.readouterr().out)
    assert replies[0] == replies[1] and replies[0].strip()
    assert len(streams) == 1 and streams[0].verify_forwards > 0


def test_cli_artifact_search(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _build(tmp_path / "dist" / "tiny-llama-q4bf16")
    capsys.readouterr()
    cli.main(["--model", "tiny-llama", "--quantization", "q4bf16", "--prompt", "hi",
              "--temperature", "0", "--max-gen-len", "4", "--max-window-size", "64",
              "--device", "cpu"])
    err = capsys.readouterr().err
    assert "using checkpoint dist/tiny-llama-q4bf16" in err
    assert "decode:" in err


def test_cli_artifact_search_skips_wrong_quantization(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _build(tmp_path / "dist" / "tiny-llama", quant="q3bf16")
    capsys.readouterr()
    assert cli.find_artifacts("tiny-llama", "q4bf16") is None
    assert "built as q3bf16" in capsys.readouterr().err
    assert cli.find_artifacts("tiny-llama", "q3bf16") == "dist/tiny-llama"
    with pytest.raises(SystemExit, match="need --weights DIR or --random-weights"):
        cli.main(["--model", "tiny-llama", "--prompt", "hi", "--device", "cpu"])


def test_port_engine_on_a_jax_built_checkpoint(tmp_path, capsys):
    out = str(tmp_path / "jck")
    jbuild.main(["--model", "tiny-llama", "--random", "--quantization", "q4bf16", "-o", out,
                 "--platform", "cpu"])
    capsys.readouterr()
    cfg = get_config("tiny-llama")
    prompt = [int(t) for t in np.random.default_rng(0).integers(3, 256, 11)]
    jparams, _ = jload(out)
    want = JEngine(cfg, jparams, max_seq_len=128).generate(
        [prompt], JGen(max_new_tokens=12, temperature=0.0))
    params, meta = load_params(out, device="cpu")
    assert meta["built_with"] == "mlc_llm_tpu.build"
    eng = InferenceEngine(cfg, params, max_seq_len=128, device="cpu")
    assert eng.generate([prompt], GenerationConfig(max_new_tokens=12, temperature=0.0)) == want


def test_serve_weights_answers_a_request(tmp_path):
    out = tmp_path / "ck"
    _build(out)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = subprocess.Popen(
        [sys.executable, "-m", "mlc_llm_tpu_torch.serve", "--model", "tiny-llama", "--weights",
         str(out), "--device", "cpu", "--paged", "--max-batch", "2", "--max-seq-len", "64",
         "--page-size", "16", "--port", str(port)],
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
        res = subprocess.run(
            [sys.executable, "-m", "mlc_llm_tpu_torch.serve", "--connect", f"127.0.0.1:{port}",
             "--prompt-ids", "1,2,3", "--temperature", "0", "--max-gen-len", "4"],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert res.returncode == 0, res.stdout + res.stderr
        assert 1 <= len(res.stdout.split()) <= 4
        assert "done" in res.stderr
    finally:
        srv.kill()  # the exact process we started
        srv.wait()


def test_full_version():
    assert full_version().startswith("0.1.0+g")
