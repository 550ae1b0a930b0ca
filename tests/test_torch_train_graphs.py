"""The trainer's graphed UNet apply against its eager one, on the card.

``make_train_apply`` replays CUDA graphs for a remat'd bf16 full finetune
over fp32 masters (``graph_refusal``); these tests hold it against the same
apply with the graphs refused, at the tiny preset's widths on 16 x 16
latents (so the top level's self-attention takes the flash kernels), inside
``batch_invariant()`` (so the 3x3 convs take the tap-GEMM): the masters,
the ``.grad`` sums and the adamw moments bit for bit, a master written or
moved between replays, and the kernel counters. Every test carries the
``cuda`` marker and skips without a card. The module imports neither jax
nor ddpo_tpu; on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graphs.py
"""

import copy
from types import SimpleNamespace

import pytest
import torch

from ddpo_torch.core.scheduler import DDIMScheduler
from ddpo_torch.ops import _build, conv
from ddpo_torch.ops.invariance import batch_invariant
from ddpo_torch.pipelines import policy_gradient as pg
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState, _apply, _take_grads
from ddpo_torch.utils.serialization import build_models, init_weights_

B, T, CLIP = 2, 3, 1e-2
TS = [901, 601, 301]
ADAMW = SimpleNamespace(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
                        weight_decay=1e-4, max_grad_norm=1.0, lr_schedule="constant",
                        lr_warmup_steps=0, lr_total_steps=None, optimizer="adamw")


@pytest.fixture
def cuda(monkeypatch):
    """The card, with cuDNN's deterministic algorithms on both sides: a
    bit comparison of two backwards needs the library's weight gradients to
    sum in one order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs run only on the GPU)")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


def _eager(monkeypatch):
    """Refuse the graphs from here on: the eager path of the same apply."""
    monkeypatch.setattr(pg, "graph_refusal", lambda *a: "eager")


def _unet(device):
    _, _, unet = build_models("tiny", device)
    init_weights_(unet, torch.Generator(device=device).manual_seed(0))
    return unet.float().requires_grad_(True)


def _batches(unet, device):
    """T trained timesteps of a B-row batch, on-policy: next latents drawn
    through the DDIM step from the UNet's own eps, old log-probs offset."""
    g = torch.Generator(device=device).manual_seed(1)
    sched = DDIMScheduler()
    state = sched.set_timesteps(sched.create_state(device), 10)
    prompt, uncond = (torch.randn(B, 77, 32, generator=g, device=device).bfloat16()
                      for _ in range(2))
    apply = pg.make_train_apply(unet, torch.bfloat16, remat=True)
    params = dict(unet.named_parameters())
    batches = []
    with torch.no_grad(), batch_invariant():
        for t in TS:
            x = torch.randn(B, 4, 16, 16, generator=g, device=device)
            ts = torch.full((B,), t, device=device)
            eps_u, eps_c = apply(params, torch.cat([x, x]), torch.cat([ts, ts]),
                                 torch.cat([uncond, prompt])).chunk(2)
            nxt, lp = sched.step(state, eps_u + 5.0 * (eps_c - eps_u), ts, x,
                                 noise=torch.randn(x.shape, generator=g, device=device),
                                 eta=1.0)
            batches.append({"latents": x, "next_latents": nxt, "ts": ts,
                            "log_probs": lp + torch.tensor([0.3, -3.0], device=device) * CLIP,
                            "advantages": torch.tensor([1.5, -0.7], device=device),
                            "prompt_embeds": prompt, "uncond_embeds": uncond})
    return batches, sched, state


def _train(unet, batches, sched, sched_state):
    """A warm-up apply whose gradient is dropped, then two rounds of T
    applies and an adamw step; returns each round's ``.grad`` sums, the
    masters and the optimizer state."""
    params = dict(unet.named_parameters())
    state = AccumulatingTrainState(pg.make_train_apply(unet, torch.bfloat16, remat=True),
                                   params, build_optimizer(ADAMW), accumulate=False)
    loss_args = (True, 5.0, 1.0, CLIP, True)
    sums = []
    with batch_invariant():
        _apply(state, batches[0], sched, sched_state, *loss_args)
        _take_grads(params)
        for _ in range(2):
            for batch in batches:
                _apply(state, batch, sched, sched_state, *loss_args)
            sums.append({k: p.grad.clone() for k, p in params.items()})
            grads = _take_grads(params)
            for g in grads.values():
                g.div_(T)
            state.apply_gradients(grads=grads)
    torch.cuda.synchronize()
    return sums, {k: p.detach().clone() for k, p in params.items()}, state.opt_state


def _assert_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what} {k} differs"


@pytest.mark.cuda
def test_graphed_updates_equal_eager(cuda, monkeypatch):
    """3 graphed timesteps (the capture and two replays, after an eager
    warm-up), an adamw step, then 3 replays: the ``.grad`` sums, the masters
    and the moments equal the eager path's bit for bit. Had autograd taken a
    graph's gradient buffer as a master's ``.grad``, the next replay would
    have overwritten it and the sums would differ."""
    unet = _unet(cuda)
    batches, sched, sched_state = _batches(unet, cuda)
    before = dict(pg.train_graphs)
    graphed = _train(copy.deepcopy(unet), batches, sched, sched_state)
    assert pg.train_graphs == {"eager": before["eager"] + 1,
                               "captures": before["captures"] + 1,
                               "replays": before["replays"] + 5}
    _eager(monkeypatch)
    rng = torch.cuda.get_rng_state()
    eager = _train(copy.deepcopy(unet), batches, sched, sched_state)
    # the UNet draws no random numbers: checkpoint's RNG-state save is moot
    assert torch.equal(torch.cuda.get_rng_state(), rng)
    for i in range(2):
        _assert_equal(graphed[0][i], eager[0][i], f"round {i} .grad sum")
    _assert_equal(graphed[1], eager[1], "master")
    for moment in ("mu", "nu"):
        _assert_equal(graphed[2][moment], eager[2][moment], moment)


def _forward(apply, params, batch):
    x, ts = batch["latents"], batch["ts"]
    with batch_invariant():
        return apply(params, torch.cat([x, x]), torch.cat([ts, ts]),
                     torch.cat([batch["uncond_embeds"], batch["prompt_embeds"]]))


@pytest.mark.cuda
def test_replays_read_the_masters_where_they_are(cuda, monkeypatch):
    """A conv master written in place between replays reaches the tap-GEMM
    (its operand is laid out inside the graph, from the fresh cast), and a
    master moved to new storage makes the next call capture anew."""
    unet = _unet(cuda)
    batches, _, _ = _batches(unet, cuda)
    params = dict(unet.named_parameters())
    apply = pg.make_train_apply(unet, torch.bfloat16, remat=True)
    for _ in range(2):  # the eager warm-up, then the capture
        _forward(apply, params, batches[0])
    weight = params["conv_in.weight"]
    outs = []
    with torch.no_grad():
        weight.mul_(1.5)
    outs.append(_forward(apply, params, batches[1]))  # a replay
    with torch.no_grad():
        weight.data = weight.data * 0.5  # new storage
    captures = pg.train_graphs["captures"]
    outs.append(_forward(apply, params, batches[1]))
    assert pg.train_graphs["captures"] == captures + 1
    _eager(monkeypatch)
    eager = pg.make_train_apply(unet, torch.bfloat16, remat=True)
    want = _forward(eager, params, batches[1])
    assert torch.equal(outs[1], want)
    with torch.no_grad():
        weight.data = weight.data * 2.0
    assert torch.equal(outs[0], _forward(eager, params, batches[1]))


def _counts():
    return dict(_build.launches), dict(conv.operand_cache)


def _apply_counts(apply, params, batch):
    """The kernel launches and operand lookups one apply and its backward add."""
    before = _counts()
    with batch_invariant():  # the backward too, as the trainer runs it
        _forward(apply, params, batch).float().square().sum().backward()
    torch.cuda.synchronize()
    return tuple({k: n - old[k] for k, n in new.items()} for new, old in zip(_counts(), before))


@pytest.mark.cuda
def test_replays_count_what_eager_counts(cuda, monkeypatch):
    """The capture and each replay add to ``_build.launches`` and
    ``operand_cache`` what an eager apply adds: every trainer lookup a miss,
    one tap layout and one tap-GEMM launch a conv in the forward and in the
    remat recompute."""
    unet = _unet(cuda)
    batches, _, _ = _batches(unet, cuda)
    params = dict(unet.named_parameters())
    apply = pg.make_train_apply(unet, torch.bfloat16, remat=True)
    got = [_apply_counts(apply, params, batches[0]) for _ in range(3)]  # eager, capture, replay
    _eager(monkeypatch)
    want = _apply_counts(pg.make_train_apply(unet, torch.bfloat16, remat=True), params, batches[0])
    launches, cache = want
    assert cache["lookups"] == cache["misses"] == launches["tap_layout"] == launches["conv3x3"] > 0
    assert launches["flash_fwd"] > 0 and launches["flash_bwd_dkv"] > 0
    for counts in got:
        assert counts == want
