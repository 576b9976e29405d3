"""The port's C++ host library (``mlc_llm_tpu_torch/native.py``,
``csrc/host/*.cc``): the cases of tests/test_native.py against the port's
own conversation.py and checkpoint format (every template's prompt, from
the C++ engine and from conversation.py, also equal to the JAX package's
conversation.py on the same messages), the build's atomic replace
under two concurrent builders, and the reads the checkpoint loader makes
(byte ranges, the pinned ring's fills).

The library is built in a fixture, never at collection: every worker
collects the same tests whether or not it builds here.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mlc_llm_tpu import conversation as jconv
from mlc_llm_tpu_torch import native
from mlc_llm_tpu_torch.conversation import CONV_TEMPLATES, get_conversation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    return native.get_lib()


def _native_twin(name):
    c = CONV_TEMPLATES[name]
    n = native.NativeConversation(c.system, c.roles, c.sep_style.value, c.sep, c.sep2,
                                  offset=c.offset)
    for role, msg in c.messages:
        n.append(role, msg)
    return n


def test_templates_are_jax_templates():
    assert sorted(CONV_TEMPLATES) == sorted(jconv.CONV_TEMPLATES)


@pytest.mark.parametrize("name", sorted(CONV_TEMPLATES))
def test_cpp_python_prompt_parity(lib, name):
    py = get_conversation(name)
    cc = _native_twin(name)
    jx = jconv.get_conversation(name)
    for user, reply in [("Hello there", "General Kenobi"), ("How are you?", None)]:
        for c in (py, cc, jx):
            c.append(py.roles[0], user)
            c.append(py.roles[1], None)
        want = jx.get_prompt_unprocessed()
        assert py.get_prompt_unprocessed() == want, name
        assert cc.get_prompt_unprocessed() == want, name
        if reply is not None:
            for c in (py, cc, jx):
                c.update_last(reply)


@pytest.mark.parametrize("name", sorted(CONV_TEMPLATES))
def test_cpp_python_full_prompt_parity(lib, name):
    py = get_conversation(name)
    cc = _native_twin(name)
    jx = jconv.get_conversation(name)
    for c in (py, cc, jx):
        c.append(py.roles[0], "Question?")
        c.append(py.roles[1], None)
    assert py.get_prompt() == jx.get_prompt() and cc.get_prompt() == jx.get_prompt()
    for c in (py, cc, jx):
        c.reset()
    assert py.get_prompt() == jx.get_prompt() and cc.get_prompt() == jx.get_prompt()


def test_utf8_safe_prefix(lib):
    s = "héllo 世界".encode("utf-8")
    assert native.utf8_safe_prefix(s) == len(s)
    for i in range(len(s)):  # every cut decodes; at most 3 bytes held back
        p = native.utf8_safe_prefix(s[:i])
        s[:p].decode("utf-8")
        assert i - p <= 3


def test_find_stop_and_holdback(lib):
    assert native.find_stop(b"hello ### there", b"###")[0] == 6
    assert native.find_stop(b"hello ##", b"###") == (-1, 2)  # "##" could become "###"
    assert native.find_stop(b"hello", b"###") == (-1, 0)


def test_parallel_file_load(lib, tmp_path):
    rng = np.random.default_rng(0)
    paths, bufs, wants = [], [], []
    for i in range(5):
        data = rng.integers(0, 255, size=1000 + i * 17, dtype=np.uint8)
        p = tmp_path / f"shard{i}.bin"
        p.write_bytes(data.tobytes())
        paths.append(str(p))
        # NumPy arrays and CPU tensors (a view: data_ptr counts its offset)
        bufs.append(np.empty_like(data) if i % 2 else torch.empty(len(data) + 8,
                                                                  dtype=torch.uint8)[8:])
        wants.append(data)
    native.load_files_parallel(paths, bufs, num_threads=3)
    for b, w in zip(bufs, wants):
        np.testing.assert_array_equal(np.asarray(b), w)


def test_parallel_load_missing_file_raises(lib, tmp_path):
    with pytest.raises(IOError):
        native.load_files_parallel([str(tmp_path / "nope.bin")], [np.empty(10, np.uint8)])


def test_parallel_load_ranges(lib, tmp_path):
    # one file read as pieces by several threads; a range past the end raises
    data = np.random.default_rng(1).integers(0, 255, size=10_000, dtype=np.uint8)
    p = tmp_path / "leaf.bin"
    p.write_bytes(data.tobytes())
    out = torch.empty(len(data), dtype=torch.uint8)
    offs = list(range(0, len(data), 1500))
    native.load_files_parallel([str(p)] * len(offs),
                               [out[o:o + 1500] for o in offs], num_threads=4, offsets=offs)
    np.testing.assert_array_equal(out.numpy(), data)
    with pytest.raises(IOError, match="leaf.bin"):
        native.load_files_parallel([str(p)], [torch.empty(100, dtype=torch.uint8)],
                                   offsets=[len(data) - 50])


def test_checkpoint_uses_native_loader(lib, tmp_path, monkeypatch):
    from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache, init_random_params
    from mlc_llm_tpu_torch.utils import checkpoint

    cfg = get_config("tiny-llama")
    params = init_random_params(cfg, "q4bf16", seed=9, device="cpu")
    checkpoint.save_params(params, str(tmp_path / "ck"), meta={"model": cfg.name})
    reads = []
    real = native.load_files_parallel

    def spy(paths, buffers, num_threads=8, offsets=None):
        reads.extend(paths)
        return real(paths, buffers, num_threads, offsets)

    monkeypatch.setattr(native, "load_files_parallel", spy)
    monkeypatch.setattr(checkpoint, "PIECE_BYTES", 4096)  # large leaves in several pieces
    loaded, meta = checkpoint.load_params(str(tmp_path / "ck"), device="cpu")
    files = {os.path.join(str(tmp_path / "ck"), f) for f in os.listdir(tmp_path / "ck")
             if f.endswith(".bin")}
    assert set(reads) == files and len(reads) > len(files) and meta["model"] == cfg.name
    toks = torch.tensor([[4, 5]])
    la, _ = forward(params, cfg, toks, init_kv_cache(cfg, 1, 8, device="cpu"), last_only=True)
    lb, _ = forward(loaded, cfg, toks, init_kv_cache(cfg, 1, 8, device="cpu"), last_only=True)
    assert torch.equal(la, lb)


def test_checkpoint_leaf_of_wrong_size_raises(lib, tmp_path):
    from mlc_llm_tpu_torch.models import get_config, init_random_params
    from mlc_llm_tpu_torch.utils import checkpoint

    cfg = get_config("tiny-llama")
    ck = str(tmp_path / "ck")
    checkpoint.save_params(init_random_params(cfg, "q4bf16", seed=1, device="cpu"), ck)
    with open(os.path.join(ck, "final_ln.w.bin"), "ab") as f:
        f.write(b"\0\0")
    with pytest.raises(ValueError, match="final_ln.w.bin"):
        checkpoint.load_params(ck, device="cpu")


@pytest.mark.parametrize("size", [1, 7, 4096, 10**6])
def test_stage_chunks_cover_every_byte_once(size):
    # the pinned ring's fills, read into a CPU buffer here: every leaf's
    # bytes land once, in order, each fill at most one buffer
    from mlc_llm_tpu_torch.utils.checkpoint import _stage_chunks

    rng = np.random.default_rng(size)
    leaves = [(f"leaf{i}", torch.from_numpy(rng.integers(0, 255, n, dtype=np.uint8)))
              for i, n in enumerate([0, 5, 3000, 1, 9000, 2])]
    got = {name: torch.zeros_like(t) for name, t in leaves}
    src = dict(leaves)
    chunks = _stage_chunks(leaves, size)
    for c in chunks:
        assert sum(n for _, _, n, _ in c) <= size
    assert all(sum(n for _, _, n, _ in c) == size for c in chunks[:-1])
    order = []
    for c in chunks:
        for name, off, n, flat in c:
            assert flat is src[name]
            got[name][off:off + n] = src[name][off:off + n]
            order.append((name, off))
    assert order == sorted(order, key=lambda x: ([n for n, _ in leaves].index(x[0]), x[1]))
    for name, t in leaves:
        assert torch.equal(got[name], t)


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    # two processes build into the same empty directory at once: each
    # writes its own temporary file and moves it into place, so both load
    # a whole library (a builder that wrote straight onto the library's
    # path could hand the other a half-written file)
    lib_path = str(tmp_path / "build" / "libmlc_host.so")
    code = (
        "import sys\n"
        "from mlc_llm_tpu_torch import native\n"
        f"native.LIB_PATH = {lib_path!r}\n"
        "native.get_lib()\n"
        "assert native.find_stop(b'ab###', b'###') == (2, 0)\n"
        "print('ok')\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip().endswith("ok") for o in outs)
    assert os.listdir(tmp_path / "build") == ["libmlc_host.so"]  # no temporary file left


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "HOST_SRC", str(tmp_path))  # no sources there
    with pytest.raises(RuntimeError, match="failed"):
        native.build(str(tmp_path / "out" / "libmlc_host.so"))
    assert os.listdir(tmp_path / "out") == []
