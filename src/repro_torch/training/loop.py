"""Fault-tolerant training loop (port of ``repro.training.loop``).

  * periodic checkpoints through ``repro_torch.checkpoint.store`` (the
    reference's on-disk format: atomic COMMIT, checksum-verified), keeping
    the last ``keep_last``;
  * automatic resume from the latest complete checkpoint, loaded onto
    ``device`` (the reference's ``shardings``);
  * per-step wall time with a straggler detector (steps slower than
    ``straggler_factor`` x the running median are logged and counted);
  * optional gradient compression (int8 / topk with error feedback)
    between the backward pass and the optimizer;
  * a failure-injection hook for tests (raise mid-run, resume, continue
    bit for bit on the CPU; the compressor's residual starts again from
    zero, as in the reference).

A step's wall time ends in a synchronize of the device, where the
reference blocks on its loss.
"""

from __future__ import annotations

import dataclasses
import pathlib
import shutil
import statistics
import time
from typing import Any, Iterator, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.common.device import resolve_device
from repro_torch.models.api import model_api, value_and_grad
from repro_torch.training.grad_compress import (CompressorState,
                                                compress_grads, init_state)
from repro_torch.training.optimizer import make_optimizer


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = "checkpoints"
    lr: float | None = None
    grad_compression: str = "none"        # none | int8 | topk
    topk_frac: float = 0.01
    straggler_factor: float = 3.0
    keep_last: int = 3


@dataclasses.dataclass
class LoopState:
    step: int
    params: Any
    opt_state: Any
    compressor: CompressorState
    metrics_history: list = dataclasses.field(default_factory=list)
    straggler_steps: list = dataclasses.field(default_factory=list)
    #: wall seconds of each step this run took (ending in a synchronize)
    step_seconds: list = dataclasses.field(default_factory=list)


def make_compressed_train_step(cfg, loop_cfg: LoopConfig):
    """``(step, opt)``: ``step(params, opt_state, comp_state, batch) ->
    (params, opt_state, comp_state, metrics)``."""
    api = model_api(cfg)
    opt = make_optimizer(getattr(cfg, "optimizer", "adamw"), loop_cfg.lr)

    def step(params, opt_state, comp_state, batch):
        _, metrics, grads = value_and_grad(api.loss, params, batch)
        if loop_cfg.grad_compression != "none":
            grads, comp_state, wire, dense = compress_grads(
                grads, comp_state, loop_cfg.grad_compression,
                loop_cfg.topk_frac)
            metrics = dict(metrics)
            metrics["wire_bytes"] = wire
            metrics["compression_ratio"] = dense / max(wire, 1)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, comp_state, metrics

    return step, opt


def train(cfg, data_iter: Iterator[dict], loop_cfg: LoopConfig,
          init_gen: Optional[torch.Generator] = None,
          fail_at_step: Optional[int] = None,
          device: str | torch.device | None = None,
          verbose: bool = False) -> LoopState:
    """Run (or resume) training on ``device`` (the CUDA card by default;
    raises on a host without one unless given ``device="cpu"``).
    ``fail_at_step`` raises RuntimeError right before that step runs (tests
    simulate preemption). Parameters start from ``init_gen`` (a generator
    on ``device``; seed 0 if None) unless a complete checkpoint exists."""
    dev = resolve_device(device)
    api = model_api(cfg)
    step_fn, opt = make_compressed_train_step(cfg, loop_cfg)

    # ---- resume or init --------------------------------------------------
    latest = store.latest_complete(loop_cfg.checkpoint_dir)
    if latest is not None:
        like = api.init(None, "meta")
        full_like = {"params": like, "opt": opt.init(like)}
        full = store.load(latest, full_like, dev)
        params, opt_state = full["params"], full["opt"]
        start = store.load_manifest(latest)["step"]
    else:
        gen = (init_gen if init_gen is not None
               else torch.Generator(device=dev).manual_seed(0))
        params = api.init(gen, dev)
        opt_state = opt.init(params)
        start = 0

    comp_state = init_state(params)
    st = LoopState(step=start, params=params, opt_state=opt_state,
                   compressor=comp_state)

    times = st.step_seconds
    for step_idx in range(start, loop_cfg.total_steps):
        if fail_at_step is not None and step_idx == fail_at_step:
            raise RuntimeError(f"injected failure at step {step_idx}")
        batch = next(data_iter)
        t0 = time.perf_counter()
        st.params, st.opt_state, st.compressor, metrics = step_fn(
            st.params, st.opt_state, st.compressor, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        # straggler detection against the running median
        if len(times) >= 5:
            med = statistics.median(times[-20:])
            if dt > loop_cfg.straggler_factor * med:
                st.straggler_steps.append((step_idx, dt, med))
        times.append(dt)
        st.metrics_history.append(
            {k: float(v) for k, v in metrics.items()})
        st.step = step_idx + 1
        if verbose and step_idx % 10 == 0:
            print(f"step {step_idx}: loss={float(metrics['loss']):.4f} "
                  f"({dt*1000:.0f} ms)")
        if st.step % loop_cfg.checkpoint_every == 0 or \
                st.step == loop_cfg.total_steps:
            store.save(loop_cfg.checkpoint_dir, st.step,
                       {"params": st.params, "opt": st.opt_state},
                       extra={"loss": float(metrics["loss"])})
            _gc_checkpoints(loop_cfg)
    return st


def _gc_checkpoints(loop_cfg: LoopConfig) -> None:
    d = pathlib.Path(loop_cfg.checkpoint_dir)
    steps = sorted(p for p in d.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and (p / "COMMIT").exists())
    for p in steps[:-loop_cfg.keep_last]:
        shutil.rmtree(p)
