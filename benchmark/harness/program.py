"""The system under test, set up from a configuration file: its engine
over the parameter tree that the configuration's architecture builds
(``arch/<name>.py``, its ``build_params``, with the helpers here), the
scheduler, and the warm-up of the step programs this cell's traffic
reaches.

This module and each architecture's ``build_params`` are all of the
benchmark that imports the program (``mlc_llm_tpu_torch``), each lazily,
inside the function that needs it; they import nothing else of the
repository.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

import torch


def model_config(model: dict):
    """The port's ModelConfig as the file states it. stop_tokens is empty:
    answers run to the length the traffic drew (ignore-EOS)."""
    from mlc_llm_tpu_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in model.items() if k in fields}
    kw["stop_tokens"] = ()
    return ModelConfig(**kw)


def stack_quantized(draws: Iterable[torch.Tensor], count: int, quantize, spec):
    """Quantize `count` [k, n] matrices, taken from `draws` one at a time,
    into one stacked QuantizedTensor, filling preallocated storage."""
    from mlc_llm_tpu_torch.quant import QuantizedTensor

    data = scale = zero = None
    for l, w in enumerate(draws):
        q = quantize(w, spec)
        del w
        if data is None:
            data = q.data.new_empty((count, *q.data.shape))
            scale = q.scale.new_empty((count, *q.scale.shape))
            zero = None if q.zero is None else q.zero.new_empty((count, *q.zero.shape))
            shape, spec_q = q.shape, q.spec
        data[l].copy_(q.data)
        scale[l].copy_(q.scale)
        if zero is not None:
            zero[l].copy_(q.zero)
    return QuantizedTensor(data=data, scale=scale, zero=zero, spec=spec_q, shape=shape)


def build_engine(arch, model: dict, deployment: dict, seed: int, device):
    """The engine over the parameter tree that the architecture module
    `arch` builds from the seed's draws."""
    from mlc_llm_tpu_torch.engine.engine import InferenceEngine

    cfg, params = arch.build_params(model, deployment, seed, device)
    kv = {"bfloat16": torch.bfloat16, "float16": torch.float16, "int8": torch.int8,
          "float32": torch.float32}[deployment["kv_dtype"]]
    engine = InferenceEngine(cfg, params, max_batch=deployment["max_batch"],
                             max_seq_len=deployment["max_seq_len"], cache_dtype=kv,
                             kv_layout=deployment["kv_layout"],
                             page_size=deployment.get("page_size", 128), device=device)
    del params
    return engine


def build_scheduler(engine, deployment: dict, seed: int):
    from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler

    sch = deployment.get("scheduler", {})
    return ContinuousBatchingScheduler(
        engine, seed=seed % 2**32, prefill_chunk=sch.get("prefill_chunk"),
        decode_ahead=sch.get("decode_ahead", 1), multi_step=sch.get("multi_step"))


def generation(max_new: int, temperature: float, top_p: float, seed: int):
    from mlc_llm_tpu_torch.engine.engine import GenerationConfig

    return GenerationConfig(max_new_tokens=max_new, temperature=temperature, top_p=top_p,
                            stop_tokens=(), seed=seed)


def _buckets_from(engine, lo: int, hi: int) -> List[int]:
    """The engine's buckets that a length in [lo, hi] can land in."""
    return sorted({engine.bucket_for(n) for n in (lo, hi)} |
                  {b for b in engine.buckets if lo <= b <= hi})


def warm_keys(engine, mix: dict, deployment: dict) -> List[tuple]:
    """The step programs the mix can reach on this engine, from the mix's
    ranges alone (the same set for every seed)."""
    W = engine.max_seq_len
    B = engine.max_batch
    paged = engine.kv_layout == "paged"
    keys = set()
    if mix["loop"] == "chat":
        first = mix["first_turn_tokens"]
        user = mix["user_turn_tokens"]
        # a reset: a session's first turn, or the newest turns prefilled
        # again at a window shift (at most what the window leaves)
        resets = _buckets_from(engine, first["min"],
                               max(first["max"], W - min(mix["mean_gen"], W // 2) - 1))
        for b in resets:
            keys.add(("prefill", B, b, engine.decode_window(b), not paged))
        # an append: the last answer token and a user turn, after at least
        # a first turn and one answer token
        lo_ctx = first["min"] + 1
        for b in _buckets_from(engine, user["min"] + 1, user["max"] + 1):
            for w in engine.buckets:
                if w >= engine.decode_window(min(lo_ctx + b, W)):
                    keys.add(("prefill", B, b, w, False))
        keys.add(("sample", B))
        for w in engine.buckets:
            if w >= engine.decode_window(first["min"] + 1):
                keys.add(("decode", B, w))
    else:
        pr = mix["prompt_tokens"]
        for b in _buckets_from(engine, pr["min"], pr["max"]):
            keys.add(("prefill_slots", 1, b, engine.decode_window(b), not paged))
        keys.add(("sample", 1))
        ms = deployment.get("scheduler", {}).get("multi_step")
        ks = [1]
        if isinstance(ms, str):
            K = int(ms.split(":", 1)[1]) if ":" in ms else 8
            ks += [1 << i for i in range(1, K.bit_length())]
        elif ms:
            ks.append(int(ms))
        for w in engine.buckets:
            if w >= engine.decode_window(pr["min"] + 2):
                for k in ks:
                    keys.add(("decode", B, w) if k == 1 else ("decode_k", B, k, w))
    return sorted(keys, key=repr)


def warm_up(engine, keys: List[tuple]) -> int:
    """Capture exactly `keys` through the engine's own precompile."""
    engine.precompile_keys = lambda multi_step=None: list(keys)
    try:
        return engine.precompile()
    finally:
        del engine.precompile_keys


def no_capture_in_window(engine, before: int) -> None:
    """Raise if the engine captured a step program after set-up (count
    `before`): a key that warm_keys did not foresee was captured inside
    the measured window."""
    progs = engine.programs
    if progs.count != before:
        raise RuntimeError(
            f"{progs.count - before} step program(s) captured inside the window; warm_keys "
            "missed: " + ", ".join(map(repr, [k for k in progs.capture_seconds()][before:])))
