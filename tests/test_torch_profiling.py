"""The port's span recorder (``ddpo_torch/utils/profiling.py``) on the CPU:

  - spans nest, each with its parent's ident, and ``self_seconds`` is a
    span's duration less its children's;
  - each thread keeps its own stack of open spans;
  - the store keeps the newest ``SPAN_CAPACITY`` spans;
  - ``record_function`` ranges are opened only under ``trace()``, and the
    exported trace holds the spans' names;
  - ``StepTimer`` times its phases through spans;
  - one tiny-preset epoch (``sample_trajectories``, ``vae_decode``,
    ``inner_epoch_resident`` under clip + adamw, ``refresh_sampler``)
    records one ``sampler.step`` a denoising step, one ``train.apply`` (a
    ``train.forward`` and a ``train.backward``) a trained timestep and one
    ``train.optimizer`` with one ``train.optimizer.sync`` an optimizer step,
    under the right parents, and no span calls ``torch.cuda.synchronize``
    or makes a CUDA event (both patched to raise).
"""

import json
import threading
import time
import types

import pytest
import torch

from ddpo_torch.utils import profiling
from ddpo_torch.utils.profiling import StepTimer, self_seconds, span, spans, trace


@pytest.fixture
def no_device_waits(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span reached the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)


def test_spans_nest_with_parents_and_self_time(no_device_waits):
    since = time.perf_counter()
    with span("outer") as outer:
        with span("inner") as inner:
            time.sleep(0.01)
        with span("inner"):
            with span("leaf") as leaf:
                pass
        time.sleep(0.01)
    got = spans(since=since)
    assert [s.name for s in got] == ["inner", "leaf", "inner", "outer"]
    assert outer.parent is None
    assert inner.parent == outer.ident and leaf.parent == got[2].ident
    assert len({s.ident for s in got}) == 4
    assert all(s.thread == threading.get_ident() for s in got)
    assert spans("inner", since=since) == [got[0], got[2]]
    assert inner.seconds >= 0.01 and outer.seconds >= 0.02
    children = got[0].seconds + got[2].seconds
    assert self_seconds(outer, got) == pytest.approx(outer.seconds - children)
    assert self_seconds(outer, got) >= 0.01
    assert self_seconds(leaf, got) == leaf.seconds
    assert spans(since=time.perf_counter()) == []


def test_a_span_is_kept_when_its_block_raises():
    since = time.perf_counter()
    with pytest.raises(ValueError):
        with span("outer"):
            with span("failing"):
                raise ValueError
    failing, outer = spans(since=since)
    assert (failing.name, failing.parent) == ("failing", outer.ident)
    with span("after") as after:
        pass
    assert after.parent is None  # the stack was left empty


def test_each_thread_keeps_its_own_stack():
    since = time.perf_counter()
    entered, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        entered.wait(5)
        with span("worker") as outer:
            with span("worker.inner") as inner:
                pass
        seen.update(outer=outer, inner=inner)
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()
    with span("main") as main:
        entered.set()
        assert done.wait(5)
    thread.join(5)
    assert not thread.is_alive()
    assert seen["outer"].parent is None  # not the main thread's open span
    assert seen["inner"].parent == seen["outer"].ident
    assert seen["outer"].thread != main.thread
    assert {s.name for s in spans(since=since)} == {"main", "worker", "worker.inner"}


def test_the_store_keeps_the_newest_spans():
    since = time.perf_counter()
    made = []
    for _ in range(profiling.SPAN_CAPACITY + 10):
        with span("filler") as filler:
            made.append(filler)
    kept = spans(since=since)
    assert len(kept) == profiling.SPAN_CAPACITY
    assert kept == made[10:]


def test_record_function_ranges_only_under_trace(monkeypatch, tmp_path):
    opened = []
    real = torch.profiler.record_function

    def recording(name, args=None):
        opened.append(name)
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    with span("untraced"):
        pass
    assert opened == []
    path = tmp_path / "trace.json"
    with trace(str(path)):
        with span("traced.outer"):
            with span("traced.inner"):
                torch.ones(4).sum()
    with span("after"):
        pass
    assert opened == ["traced.outer", "traced.inner"]
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"traced.outer", "traced.inner"} <= names


def test_step_timer_phases_are_spans():
    since = time.perf_counter()
    timer = StepTimer()
    with timer.phase("models"):
        time.sleep(0.01)
    with pytest.raises(KeyError):
        with timer.phase("models"):
            raise KeyError
    (first, second) = spans("models", since=since)
    assert timer.counts["models"] == 2
    assert timer.totals["models"] == pytest.approx(first.seconds + second.seconds)


def test_tiny_epoch_records_the_layers_spans(no_device_waits):
    from ddpo_torch.core.scheduler import DDIMScheduler
    from ddpo_torch.pipelines.policy_gradient import (
        make_train_apply, refresh_sampler, sampler_unet)
    from ddpo_torch.sampling import SamplerConfig, sample_trajectories, vae_decode
    from ddpo_torch.training.optim import build_optimizer
    from ddpo_torch.training.policy_gradient import AccumulatingTrainState, inner_epoch_resident
    from ddpo_torch.utils.serialization import build_models, init_weights_

    steps, b, train_bs, train_ts = 3, 2, 1, 2
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, vae, unet = build_models("tiny", "cpu")
        gen = torch.Generator().manual_seed(5)
        for m in (vae, unet):
            init_weights_(m, gen)
            m.eval().requires_grad_(False)
        ddim = DDIMScheduler()
        state = ddim.set_timesteps(ddim.create_state(), steps)
        config = SamplerConfig(num_inference_steps=steps, height=16, width=16,
                               vae_scale_factor=2)
        embeds = torch.randn(b, 77, 32, generator=gen)
        uncond = torch.randn(1, 77, 32, generator=gen).expand(b, 77, 32)
        params = dict(unet.requires_grad_(True).named_parameters())
        args = types.SimpleNamespace(
            optimizer="adamw", learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
            weight_decay=1e-4, max_grad_norm=1.0, lr_schedule="constant", lr_warmup_steps=0,
            lr_total_steps=None)
        train = AccumulatingTrainState(
            apply_fn=make_train_apply(unet, torch.float32, remat=False), params=params,
            tx=build_optimizer(args), accumulate=False)

        since = time.perf_counter()
        with torch.no_grad():
            traj = sample_trajectories(unet, ddim, state, embeds, uncond, config, generator=gen)
            vae_decode(vae, traj["final_latents"])
        samples = {k: traj[k] for k in ("latents", "next_latents", "log_probs", "ts")}
        samples.update(embeds=embeds, uncond_embeds=uncond, advantages=torch.tensor([1.0, -1.0]))
        inner_epoch_resident(train, samples, state, ddim, train_batch_size=train_bs,
                             num_train_ts=train_ts, train_cfg=True, guidance_scale=5.0, eta=1.0,
                             clip_range=1e-4, cfg_concat=True, perm=torch.arange(b),
                             t_perms=torch.arange(steps).repeat(b, 1))
        refresh_sampler(sampler_unet(unet, torch.float32), train.params)
    finally:
        torch.set_num_threads(n)

    got = spans(since=since)
    by_name = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    n_batches = b // train_bs
    assert {k: len(v) for k, v in by_name.items()} == {
        "sampler.step": steps, "sampler.trajectories": 1, "sampler.decode": 1,
        "train.forward": n_batches * train_ts, "train.backward": n_batches * train_ts,
        "train.apply": n_batches * train_ts, "train.optimizer.sync": n_batches,
        "train.optimizer": n_batches, "train.inner_epoch": 1, "train.refresh": 1}
    parent = {s.ident: s for s in got}

    def parents(name):
        return {parent[s.parent].name if s.parent is not None else None for s in by_name[name]}

    assert parents("sampler.step") == {"sampler.trajectories"}
    assert parents("train.apply") == {"train.inner_epoch"}
    assert parents("train.forward") == parents("train.backward") == {"train.apply"}
    assert parents("train.optimizer") == {"train.inner_epoch"}
    assert parents("train.optimizer.sync") == {"train.optimizer"}
    for top in ("sampler.trajectories", "sampler.decode", "train.inner_epoch", "train.refresh"):
        assert parents(top) == {None}
    for opt in by_name["train.optimizer"]:
        assert 0 <= self_seconds(opt, got) < opt.seconds
