"""DDPO training pipeline: sample -> reward -> advantage -> PPO update.

Port of ddpo_tpu/pipelines/policy_gradient.py (its host loop), on the CUDA
device, raising at once when there is none, unless ``--device cpu`` asks
for the CPU. Under ``torchrun`` (or any launcher that sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) it is data-parallel
over processes, rank r on cuda:LOCAL_RANK:

  - each rank samples its own batch (its own prompts, seed base_seed + r
    without sp, and its own sampler noise), the ranks gather rewards and
    prompts so that every rank computes the same advantages, and each
    trains on its own rows; the gradients are averaged over ranks once per optimizer
    step (parallel/collectives.py ``GradientAllReduce``, in
    ``--grad_reduce_dtype`` when given), over NCCL when every rank has a
    card of its own, else over gloo (parallel/mesh.py ``gradient_group``);
  - barriers at each phase boundary; the train infos are reduced over
    ranks and, with the parameters' digest after each epoch, checked equal
    on every rank; rank 0 writes the shared artifacts and the state, every
    rank its own host pickle;

  - the sampler runs the UNet in ``sample_dtype`` (bf16 by default) on a
    copy cast from the fp32 master parameters once per epoch;
  - reward callbacks run in a 2-worker thread pool, overlapped with the next
    sampling batch;
  - the PPO update runs the UNet in ``train_dtype`` through
    ``make_train_apply``: the fp32 masters are cast at use, a differentiable
    cast, so gradients land on them in fp32, and the whole UNet call is
    rematerialized (``torch.utils.checkpoint``) when ``remat`` is set; CFG
    is one 2B apply (``cfg_concat``) when ``train_dtype`` is bf16;
  - the fused loop trains all timesteps of a minibatch and then updates
    once (``inner_epoch_resident`` on permutations drawn on the host); the
    non-fused loop (``inner_epoch_per_timestep``) updates on each
    minibatch's last timestep;
  - the sampler's and the trainer's UNet calls run inside
    ``ops.invariance.batch_invariant()``, so the trainer's recompute at its
    own batch shape gives the sampler's bits (on the card; on the CPU it
    changes nothing);
  - with ``--lora_rank r > 0`` the UNet is frozen and rank-r adapters on
    its attention projections train instead (models/lora.py): the base is
    stored once, in ``train_dtype`` when it equals ``sample_dtype`` (no fp32
    master), the train state, the optimizer and the checkpoints hold only
    the fp32 adapters, the trainer merges them onto the base at each apply
    (outside the remat boundary), and the sampler's UNet gets the same merge
    once per epoch, so both run the same bits. The run ends by exporting the
    merged UNet as ``unet_{num_train_epochs - 1}.pkl`` under logs/<savepath>
    (utils/checkpoints.py ``save_unet``), which ``generate --iteration``
    reads;
  - full-state checkpoints (params, optimizer, RNGs, reward history, stat
    buffers) give a true resume; SIGTERM checkpoints at the epoch boundary
    and exits (every rank, when any rank got it);
  - artifacts under logs/<savepath without gs://>: rewards/, prompts/,
    callback_info/, train_info/, samples/, per_prompt_stats/,
    metrics.jsonl, reward_curve.json, and log_0.png where matplotlib
    imports. A gs:// savepath keeps its checkpoints there too and syncs
    the directory to the bucket after each epoch (rank 0, in the
    background, after the checkpoint writes land; each other rank uploads
    its own host pickle) and once more, blocking, at the end; ``--resume``
    on a fresh host fetches the checkpoints from the bucket first;
  - ``--profile_dir`` traces epoch start_epoch + 1 with torch.profiler, one
    Chrome trace per rank;
  - each rank's last line is its ``launch timeline``: the seconds from the
    process's start to ``main``, from there to the first epoch (the gloo
    group, the card's context, the kernel library's load, the models'
    init, the sampler's copy and the rest), the epochs, and from the last
    epoch's training end to the return (the checkpoint's copy, its
    write's join, the bucket sync);
  - ``--mesh_sp n`` lays the ranks out as JAX's (dp, sp) mesh
    (parallel/mesh.py: rank r has dp_index r // n, sp_index r % n; WORLD_SIZE
    must divide by n): the n ranks of an sp group share one dp slice, its
    prompts, noise and seed (base_seed + dp_index), and split the UNet.
    ``--sp_mode spatial`` (JAX's default) shards the latent's H over the
    group (parallel/spatial.py: halo convs, all-reduced GroupNorm moments,
    gathered K/V); each rank's gradients are its rows' part, so the reduce
    sums over sp and averages over dp. When the geometry check rejects it,
    the driver falls back to ``--sp_mode attention``, JAX's fallback: the
    activations are whole on every sp rank and only the self-attention
    splits its queries (parallel/sequence.py), so the gradients are whole
    and the reduce is the mean over the world; the reward callbacks then
    run on the main thread, since the attention context's collectives must
    come in the same order on every rank (printed: its collectives a sampler
    UNet forward and a trainer apply, as tp's below). Rewards and prompts
    are gathered once per dp group, and the infos are averaged over dp;
  - ``--mesh_tp n`` lays the ranks out as JAX's (dp, 1, tp) mesh (rank r:
    dp_index r // n, tp_index r % n): the n ranks of a tp group share one
    dp slice, its prompts, noise and seed, and split every transformer
    block's Linears (parallel/sharding.py: to_q/to_k/to_v and the GEGLU
    projection by output, to_out.0 and ff.net.2 by input; the heads are
    local to a rank, models/layers.py), with the collectives written out
    (parallel/tensor.py). Each rank trains and checkpoints its slices:
    the gradients are averaged over its dp group only (the ranks of its
    tp_index; with dp = 1 there is nothing to reduce), the optimizer takes
    its whole-tensor reductions over the tp group (training/optim.py), the
    digests compare the gathered parameters, and rank 0 writes the
    gathered state, so a checkpoint resumes at any tp. Printed: the tp
    collectives a sampler UNet forward and a trainer apply;
  - ``--resident_inner_loop True`` changes only where the fused loop's
    permutations come from and which rows a rank trains: drawn on the
    device from one generator seeded alike on every rank, the minibatches
    global (train batch times dp), each rank training its dp rows of each
    after gathering the epoch's samples over its dp group.

JAX's refusals hold: tp with sp, LoRA with tp, and ``--grad_reduce_dtype``
with sp or tp.

Run: python -m ddpo_torch.pipelines.policy_gradient --dataset compressed-animals
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import random
import signal
import socket
import time
from concurrent import futures
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ddpo_torch import training
from ddpo_torch.models.lora import init_lora, merge_lora, n_lora_params, target_paths
from ddpo_torch.models.tokenizer import make_uncond_ids
from ddpo_torch.ops.invariance import batch_invariant
from ddpo_torch.ops.attention import set_attention_sharding
from ddpo_torch.ops.spatial import all_gather, comm_counts, validate_spatial_geometry
from ddpo_torch.parallel import (
    GradientAllReduce,
    MeshConfig,
    create_mesh,
    all_gather_array,
    all_gather_strings,
    all_processes_equal,
    destroy_distributed,
    digest,
    gradient_group,
    local_batch_size,
    local_shard,
    maybe_initialize_distributed,
    process_barrier,
    process_count,
    process_index,
    worker_sum,
)
from ddpo_torch.parallel.sharding import TensorParallel, param_specs
from ddpo_torch.parallel.spatial import levels_of, spatial_apply
from ddpo_torch.sampling import SamplerConfig, sample_trajectories, vae_decode
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import (
    AccumulatingTrainState,
    inner_epoch_per_timestep,
    inner_epoch_resident,
)
from ddpo_torch.training.stat_tracking import PerPromptStatTracker
from ddpo_torch.utils import Timer, fs
from ddpo_torch.utils.checkpoints import (
    host_file,
    last_save,
    prune_checkpoints,
    restore_train_state,
    save_train_state,
    save_unet,
    wait_for_pending_saves,
)
from ddpo_torch.utils.images import save_image
from ddpo_torch.utils.metrics import MetricsLogger
from ddpo_torch.utils.parser import Parser as BaseParser
from ddpo_torch.utils.profiling import StepTimer, launch_timeline, process_seconds, trace
from ddpo_torch.utils.serialization import (
    async_to_bucket,
    load_stable_diffusion,
    resolve_device,
)


class Parser(BaseParser):
    config: str = "ddpo_torch.config.base"
    dataset: str = "compressed_animals"


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


REDUCE_DTYPES = {"none": None, "float32": torch.float32, "bfloat16": torch.bfloat16}


SP_MODES = ("spatial", "attention")


class _InlineExecutor:
    """``submit`` runs the call at once, on this thread (the reward
    callbacks of the attention mode)."""

    def submit(self, fn, *args) -> futures.Future:
        done = futures.Future()
        done.set_result(fn(*args))
        return done

    def shutdown(self) -> None:
        pass


def gradient_reduce(mesh, spatial: bool, group, backend: str,
                    reduce_dtype: Optional[torch.dtype] = None) -> Optional[GradientAllReduce]:
    """The train state's gradient reduce: None in one process without a
    reduce dtype (JAX's dp = 1 shard_map casts, so one process still casts
    to it and back). In the spatial mode each sp rank's gradients are its
    rows' part, so the reduce sums over the world and divides by dp (the
    sum over sp, the mean over dp); otherwise the gradients are whole and
    it is the mean over the world. Under tp each rank holds other slices
    of the sharded gradients than its tp neighbours (of the same shapes:
    a world reduce would average different slices without an error), so
    the reduce is the mean over its dp group, the ranks of its tp_index
    (``mesh.grad_group``: NCCL when their cards differ), and with dp = 1
    there is none."""
    if mesh.tp > 1:
        assert reduce_dtype is None, "--grad_reduce_dtype supports pure-dp meshes"
        return GradientAllReduce(mesh.grad_group, mesh.grad_backend) if mesh.dp > 1 else None
    if process_count() == 1 and reduce_dtype is None:
        return None
    return GradientAllReduce(group, backend, reduce_dtype, divisor=mesh.dp if spatial else None)


def make_train_apply(unet: torch.nn.Module, compute_dtype: torch.dtype,
                     remat: bool, base: Optional[Dict[str, torch.Tensor]] = None,
                     spatial=None) -> Callable:
    """The trainer's UNet apply over a dict of master parameters.

    Each master is cast to ``compute_dtype`` at use, inside the call (as
    flax does with dtype=bf16 over fp32 params): the cast gives the bf16
    values the sampler's once-per-epoch cast gives, and it is differentiable,
    so the gradients reach the masters in their own dtype. With ``remat``
    the whole call is checkpointed and recomputed in the backward.

    With ``base`` (LoRA) the params are the adapters: ``merge_lora`` puts
    them onto the frozen base first, outside the checkpoint, so the
    backward recomputes the UNet but not the merge.

    With ``spatial`` (an ops.spatial.Axis, which ``unet`` is set to) the
    apply takes the full latents and runs the UNet on this rank's rows
    (parallel/spatial.py ``spatial_apply``), the checkpoint around the
    sharded UNet call.
    """
    if spatial is not None:
        unet.set_spatial(spatial)

    def run(params, latents, t, context):
        cast = {k: p.to(compute_dtype) for k, p in params.items()}
        return functional_call(unet, cast, (latents, t, context))

    def apply(params: Dict[str, torch.Tensor], latents, t, context):
        if base is not None:
            params = merge_lora(base, params)

        def call(x, t, context):
            if remat:
                return checkpoint(run, params, x, t, context, use_reentrant=False)
            return run(params, x, t, context)

        if spatial is not None:
            return spatial_apply(call, spatial, levels_of(unet))(latents, t, context)
        return call(latents, t, context)

    return apply


def sampler_unet(unet: torch.nn.Module, sample_dtype: torch.dtype,
                 own=()) -> torch.nn.Module:
    """The UNet the sampler calls, in ``sample_dtype``; ``refresh_sampler``
    writes the trained values into it.

    Where ``unet``'s parameters are already in ``sample_dtype`` it shares
    them, except those named in ``own`` (LoRA's merged targets), which get
    copies of their own; with nothing of its own it is ``unet`` itself.
    Otherwise it is a full copy at ``sample_dtype``.
    """
    if next(unet.parameters()).dtype != sample_dtype:
        return copy.deepcopy(unet).to(sample_dtype).requires_grad_(False)
    if not own:
        return unet
    shared = copy.deepcopy(unet, {id(p): p for p in unet.parameters()})
    for name in own:
        path, _, leaf = name.rpartition(".")
        module = shared.get_submodule(path)
        setattr(module, leaf, torch.nn.Parameter(getattr(module, leaf).detach().clone(),
                                                 requires_grad=False))
    return shared


@torch.no_grad()
def refresh_sampler(sample_unet: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy (casting) every entry of ``params`` into the sampler's UNet,
    skipping the tensors the two share."""
    for name, ps in sample_unet.named_parameters():
        if ps is not params[name]:
            ps.copy_(params[name])


def _fetch_checkpoints(savepath: str, ckpt_root: str) -> None:
    """Resume on a fresh host: one rank per host pulls savepath/checkpoints
    from the bucket into the local mirror, when the mirror has none; the
    other ranks wait for it."""
    local = os.path.join(ckpt_root, "checkpoints")
    hosts = all_gather_strings([socket.gethostname()])
    rank = process_index()
    if hosts.index(hosts[rank]) == rank and not os.path.isdir(local):
        n = fs.get_dir(os.path.join(savepath, "checkpoints"), local)
        if n:
            print(f"[ pg ] fetched remote checkpoints from {savepath}")
    process_barrier("pg_fetch_checkpoints")


def main(argv=None):
    entered = time.perf_counter()
    before_main = process_seconds()  # the interpreter and the imports, torch's first
    boot = StepTimer()  # the start-up's parts, to the first epoch
    with boot.phase("gloo_group"):
        maybe_initialize_distributed()
    set_attention_sharding(None)  # a previous run's context must not leak into this one
    args = Parser().parse_args("pg", argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from ddpo_torch.ops._build import load_library

        with boot.phase("cuda_context"):
            torch.zeros(1, device=device)
        with boot.phase("kernel_library"):  # the sources' hash, then the load
            load_library()
    if args.sp_mode not in SP_MODES:
        raise ValueError(f"--sp_mode {args.sp_mode!r} is not one of {SP_MODES}")
    reduce_dtype = REDUCE_DTYPES[args.grad_reduce_dtype]
    if reduce_dtype is not None:
        assert args.fused_train_loop, "--grad_reduce_dtype requires the fused train loop"
        assert args.mesh_sp == 1 and args.mesh_tp == 1, (
            "--grad_reduce_dtype supports pure-dp meshes")
    # JAX's refusals, with its messages
    assert not (args.mesh_tp > 1 and args.mesh_sp > 1), (
        "mesh_sp and mesh_tp cannot be combined for training: XLA's "
        "manual<->auto partitioner boundary miscounts 3x3 conv weight grads "
        "exactly 2x with two manual attention axes (ops/attention.py "
        "docstring). Version-gated: when tests/test_parallel.py::"
        "test_sp_tp_combined_conv_grad_miscount_canary goes red, a jax "
        "upgrade fixed the boundary — remove this assert per the canary's "
        "docstring."
    )
    if args.lora_rank > 0:
        assert args.mesh_tp == 1, (
            "lora_rank requires tp=1: adapters replicate and the frozen base "
            "stays whole (tp shards full-finetune states instead)"
        )
    with boot.phase("gloo_group"):
        mesh = create_mesh(MeshConfig(sp=args.mesh_sp, tp=args.mesh_tp), device)
        # under tp the gradients' mean runs over the dp group (gradient_reduce)
        group, backend = (gradient_group(device) if mesh.tp == 1 else
                          (mesh.grad_group, mesh.grad_backend if mesh.dp > 1 else "none"))
    rank, world = process_index(), process_count()
    sp_spatial = mesh.sp > 1 and args.sp_mode == "spatial"

    # per rank (one device a rank), as JAX's per-process local batch
    sample_bs = local_batch_size(args.sample_batch_size)
    train_bs = local_batch_size(args.train_batch_size)
    train_effective_bs = train_bs * args.train_accumulation_steps
    total_samples_per_epoch = args.num_sample_batches_per_epoch * sample_bs
    print(f"[ pg ] device: {device} | rank {rank} of {world} | gradient all-reduce: "
          f"{backend}, {args.grad_reduce_dtype}")
    print(f"[ pg ] mesh: dp={mesh.dp} sp={mesh.sp} tp={mesh.tp} ({world} processes; "
          f"dp_index {mesh.dp_index}, sp_index {mesh.sp_index}, tp_index {mesh.tp_index})")
    print(
        f"[ pg ] sample batch: {sample_bs} | train batch: {train_bs} | "
        f"effective: {train_effective_bs} | samples/epoch: {total_samples_per_epoch} "
        f"(per dp slice; global sample batch {args.sample_batch_size * mesh.dp})"
    )
    assert args.sample_batch_size >= args.train_batch_size
    assert args.sample_batch_size % args.train_batch_size == 0
    assert total_samples_per_epoch % train_effective_bs == 0
    resident = args.resident_inner_loop
    if resident:
        # the resident epoch runs over the whole (dp-gathered) samples:
        # minibatch size and count are global (the dp factors cancel)
        n_batches_resident = (args.sample_batch_size * args.num_sample_batches_per_epoch
                              ) // args.train_batch_size
        assert n_batches_resident % args.train_accumulation_steps == 0, (
            f"resident_inner_loop: {n_batches_resident} minibatches/epoch not "
            f"divisible by train_accumulation_steps={args.train_accumulation_steps}"
        )

    worker_id = rank
    remote = fs.is_remote(args.savepath)
    # every artifact is mirrored under logs/, a remote savepath's too
    localpath = "logs/" + args.savepath.replace("gs://", "")
    os.makedirs(localpath, exist_ok=True)
    metrics = MetricsLogger(localpath, enabled=rank == 0)

    # --------------------------------- models --------------------------------- #
    master_dtype = _dtype(args.dtype)
    sample_dtype = _dtype(args.sample_dtype)
    train_dtype = _dtype(args.train_dtype)
    # base_seed, the same on every rank: the replicas start equal
    with boot.phase("models"):
        models = load_stable_diffusion(
            args.pretrained_model,
            model_preset=args.model_preset,
            device=device,
            dtype=master_dtype,
            seed=args.base_seed,
        )
    # the text encoder and the VAE compute in the sampling dtype
    models.text_encoder.to(sample_dtype)
    models.vae.to(sample_dtype)
    unet = models.unet
    print(f"[ pg ] unet params: {sum(p.numel() for p in unet.parameters()) / 1e6:.1f}M")
    if sp_spatial:
        # the spatial mode needs H divisible at every UNet level; fall back
        # to the attention mode (any geometry), as JAX does
        try:
            validate_spatial_geometry(args.resolution // 8, "sp", mesh.sp,
                                      levels=levels_of(unet))
        except ValueError as e:
            print(f"[ pg ] sp_mode=spatial rejected ({e}); "
                  "falling back to sp_mode=attention")
            sp_spatial = False
    sp_axis = mesh.axis("sp") if sp_spatial else None
    tp_layout = None
    if mesh.tp > 1:
        # each rank keeps its slices of the transformer blocks' Linears
        tp_axis = mesh.axis("tp")
        tp_layout = TensorParallel(tp_axis, param_specs(dict(unet.named_parameters())))
        unet.set_tensor_parallel(tp_axis)
        print(f"[ pg ] tp={mesh.tp}: the transformer blocks' Linears split over the tp group "
              f"({sum(p.numel() for p in unet.parameters()) / 1e6:.1f}M params on this rank; "
              f"heads local: self-attention runs the kernels on heads / {mesh.tp})")
    lora_base = None
    if args.lora_rank > 0:
        # frozen weights take no optimizer update, so they need no fp32
        # master: stored once, at train_dtype when sampling computes in it
        # too (the default bf16: 1.72 GB at SD-1.4), else at the master
        # dtype and cast at use
        unet.to(train_dtype if train_dtype == sample_dtype else master_dtype)
        lora_base = dict(unet.named_parameters())
        params = init_lora(lora_base, args.lora_rank,
                           torch.Generator(device=device).manual_seed(args.base_seed))
        for p in params.values():
            p.requires_grad_(True)
        print(f"[ pg ] lora: rank {args.lora_rank}, {n_lora_params(params)} trainable "
              f"in {len(params)} tensors (base frozen)")
        own = [path + ".weight" for path in target_paths(lora_base)]
    else:
        # the UNet holds the master parameters (the optimizer's), trained
        # in place
        params = dict(unet.requires_grad_(True).named_parameters())
        own = ()
    # the sampler's UNet at the sampling dtype, refreshed from the trained
    # values once per epoch
    with boot.phase("sampler_copy"):
        sample_unet = sampler_unet(unet, sample_dtype, own)
    sample_apply = sample_unet
    if sp_spatial:
        sample_unet.set_spatial(sp_axis)
        sample_apply = spatial_apply(sample_unet, sp_axis, levels_of(unet))
        print(f"[ pg ] sp={mesh.sp} spatial: the UNet runs on this rank's latent rows "
              "(halo convs + all-reduced GroupNorm moments + gathered K/V)")
    elif mesh.sp > 1:
        set_attention_sharding(mesh, batch_axis="dp", seq_axis="sp")
        print(f"[ pg ] sp={mesh.sp} attention: self-attention splits its queries over sp; "
              "the rest computes whole on every sp rank")

    sample_calls = {"n": 0}  # sampler UNet calls, for the tp collectives a call

    def counted_sample_apply(*a):
        sample_calls["n"] += 1
        return sample_apply(*a)

    scheduler = models.scheduler
    sched_state = scheduler.set_timesteps(
        scheduler.create_state(device), args.n_inference_steps
    )
    # CFG as one 2B apply for bf16 training; fp32 keeps the two-apply form,
    # as the JAX package chooses
    cfg_concat = train_dtype == torch.bfloat16

    # ------------------------------- train state ------------------------------ #
    fused = args.fused_train_loop
    # over ranks, or in one process a cast to --grad_reduce_dtype and back
    # (JAX's dp = 1 shard_map)
    grad_reduce = gradient_reduce(mesh, sp_spatial, group, backend, reduce_dtype)
    train_apply = make_train_apply(unet, train_dtype, args.remat, lora_base, sp_axis)
    applies = {"n": 0}  # trainer UNet applies, for the tp collectives a call

    def counted_apply(*a):
        applies["n"] += 1
        return train_apply(*a)

    state = AccumulatingTrainState(
        apply_fn=counted_apply,
        params=params,
        tx=build_optimizer(args, tp=tp_layout),
        # the fp32 accumulation buffer (3.4 GB at SD-1.4 scale) exists only
        # when something accumulates: explicit accumulation steps, or the
        # non-fused loop, which accumulates over the trained timesteps
        accumulate=args.train_accumulation_steps > 1 or not fused,
        grad_reduce=grad_reduce,
        tp=tp_layout,
    )
    ckpt_root = localpath if remote else args.savepath
    start_epoch = 0
    restored_host = None
    if args.resume:
        if remote:
            _fetch_checkpoints(args.savepath, ckpt_root)
        restored, step = restore_train_state(ckpt_root)
        all_processes_equal(step, "restored checkpoint step")
        if restored is not None:
            state.load_state_dict(restored["state"])
            start_epoch = int(restored["epoch"]) + 1
            restored_host = restored.get("host")
            print(f"[ pg ] resumed from checkpoint at epoch {restored['epoch']}")
    if world > 1:
        all_processes_equal(state.global_params(), "initial params")

    vae_scale = 2 ** (len(models.vae.config.block_out_channels) - 1)
    sampler_config = SamplerConfig(
        num_inference_steps=args.n_inference_steps,
        guidance_scale=args.guidance_scale,
        eta=args.eta,
        height=args.resolution,
        width=args.resolution,
        vae_scale_factor=vae_scale,
        latent_channels=models.vae.config.latent_channels,
    )

    def text_encode(ids: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return models.text_encoder(torch.as_tensor(ids, device=device))

    epoch_kwargs = dict(
        scheduler_state=sched_state, scheduler=scheduler, train_cfg=args.train_cfg,
        guidance_scale=args.guidance_scale, eta=args.eta,
        clip_range=args.ppo_clip_range, cfg_concat=cfg_concat,
        accumulation_steps=args.train_accumulation_steps,
    )

    # ------------------------------ prompts/rewards --------------------------- #
    uncond_embed = text_encode(make_uncond_ids(models.tokenizer, 1))[0]
    sample_uncond = uncond_embed.expand(sample_bs, *uncond_embed.shape)

    assert args.filter_field in training.callback_fns, (
        f"filter_field {args.filter_field!r} is not a registered reward "
        f"(known: {sorted(training.callback_fns)}); unknown --dataset names "
        "fall back to base defaults with filter_field=None"
    )
    callback_fns = {
        args.filter_field: training.callback_fns[args.filter_field](
            vae=models.vae, cache=args.cache
        )
    }
    executor = (_InlineExecutor() if mesh.sp > 1 and not sp_spatial
                else futures.ThreadPoolExecutor(max_workers=2))

    per_prompt_stats = None
    if args.per_prompt_stats_bufsize is not None:
        per_prompt_stats = PerPromptStatTracker(
            args.per_prompt_stats_bufsize, args.per_prompt_stats_min_count
        )

    # the sampler's noise, from this rank's seed (base_seed + dp_index): each
    # dp slice draws its own, as JAX's global-mesh key gives each dp slice
    # its own, and the sp and tp ranks of a slice the same; host-side RNGs
    # (prompts, shuffles) are python's and numpy's, seeded by the parser
    # from the same seed
    sample_gen = torch.Generator(device=device).manual_seed(args.seed)
    # the resident loop's permutations: one stream, the same on every rank
    train_gen = torch.Generator(device=device).manual_seed(args.base_seed)

    mean_rewards, std_rewards = [], []
    if restored_host is not None:
        # true resume: every stateful host object continues where it stopped
        sample_gen.set_state(restored_host["sample_generator"])
        if restored_host.get("train_generator") is not None:
            train_gen.set_state(restored_host["train_generator"])
        mean_rewards = list(restored_host["mean_rewards"])
        std_rewards = list(restored_host["std_rewards"])
        if per_prompt_stats is not None and restored_host.get("per_prompt_stats"):
            per_prompt_stats.load_state_dict(restored_host["per_prompt_stats"])
        random.setstate(restored_host["py_random"])
        np.random.set_state(restored_host["np_random"])

    def host_checkpoint_state():
        return {
            "sample_generator": sample_gen.get_state(),
            "train_generator": train_gen.get_state(),
            "mean_rewards": list(mean_rewards),
            "std_rewards": list(std_rewards),
            "per_prompt_stats": per_prompt_stats.state_dict() if per_prompt_stats else None,
            "py_random": random.getstate(),
            "np_random": np.random.get_state(),
        }

    # Preemption safety: the handler only sets a flag; the loop checkpoints
    # the full state at the next epoch boundary and exits cleanly, so
    # --resume True continues exactly where the preempted run stopped.
    shutdown_requested = {"flag": False}

    def _on_sigterm(signum, frame):
        shutdown_requested["flag"] = True
        print("[ pg ] SIGTERM: checkpointing at the epoch boundary, then exiting")

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (embedded use): skip the hook
        prev_sigterm = None

    timer = Timer()
    sync_thread = None
    first_epoch_start = epochs_end = None
    leave = StepTimer()  # from the last epoch's end to the return
    for epoch in range(start_epoch, args.num_train_epochs):
        epoch_start = time.perf_counter()
        if first_epoch_start is None:
            first_epoch_start = epoch_start
        profiling = contextlib.ExitStack()
        if args.profile_dir and epoch == start_epoch + 1:
            path = os.path.join(args.profile_dir, f"epoch{epoch}_rank{rank}.json")
            profiling.enter_context(trace(path))
            print(f"[ pg ] tracing epoch {epoch} to {path}")
        # ============================ sampling phase =========================== #
        process_barrier(f"pg_sample_{epoch}")
        with torch.no_grad():
            refresh_sampler(sample_unet, state.params if lora_base is None
                            else merge_lora(lora_base, state.params))
        sampler_comm, sample_calls["n"] = {}, 0  # the sampler's UNet calls' collectives
        samples = []
        sample_phase_time = 0.0
        for i in range(args.num_sample_batches_per_epoch):
            sample_prompts, training_prompts, prompt_metadata = training.make_prompts(
                args.prompt_fn, sample_bs, args.identical_batch,
                evaluate=args.evaluate, **args.prompt_kwargs,
            )
            prompt_embeds = text_encode(models.tokenizer(list(sample_prompts)))
            timer()
            comm_before = comm_counts()
            with batch_invariant():
                traj = sample_trajectories(
                    counted_sample_apply, scheduler, sched_state, prompt_embeds, sample_uncond,
                    sampler_config, generator=sample_gen,
                )
            sampler_comm = _comm_sum(sampler_comm, _comm_since(comm_before))
            images = vae_decode(models.vae, traj["final_latents"]).cpu().numpy()
            sample_time = timer()
            sample_phase_time += sample_time

            callbacks = executor.submit(
                training.evaluate_callbacks, callback_fns, images,
                sample_prompts, prompt_metadata,
            )
            samples.append({
                "embeds": prompt_embeds,
                "latents": traj["latents"],
                "next_latents": traj["next_latents"],
                "log_probs": traj["log_probs"],
                "ts": traj["ts"],
                "prompts": np.array(sample_prompts),
                "callbacks": callbacks,
            })
            print(
                f"[ pg ] epoch {epoch} sample batch {i}: {sample_bs} samples "
                f"in {sample_time:.2f}s ({sample_bs / sample_time:.3f}/s), initial noise "
                f"digest {digest(traj['latents'][:, 0])}"
            )
            save_image(
                fs.join_and_create(localpath, f"samples/{worker_id}_{epoch}_{i}.png"),
                images[0],
            )

        # collect rewards
        for sample in samples:
            sample["rewards"], sample["callback_info"] = sample.pop("callbacks").result()[
                args.filter_field
            ]
        samples = _concat(samples)
        samples["rewards"] = np.asarray(samples["rewards"], dtype=np.float64).reshape(
            len(samples["prompts"]), -1
        )[:, 0]
        # every dp slice's rewards and prompts (once, over this rank's dp
        # group), so that all compute the same advantages; each then takes
        # its dp slice's rows
        rewards = all_gather_array(samples["rewards"], group=mesh.dp_group)
        all_prompts = np.array(all_gather_strings(samples["prompts"].tolist(),
                                                  group=mesh.dp_group))

        if per_prompt_stats is not None:
            advantages = per_prompt_stats.update(all_prompts, rewards)
            if rank == 0:
                np.save(
                    fs.join_and_create(localpath, f"per_prompt_stats/{worker_id}_{epoch}.npy"),
                    per_prompt_stats.get_stats(),
                )
        else:
            advantages = (rewards - rewards.mean()) / (rewards.std() + 1e-8)

        samples["advantages"] = torch.as_tensor(local_shard(advantages, mesh),
                                                dtype=torch.float32, device=device)
        mean_rewards.append(float(rewards.mean()))
        std_rewards.append(float(rewards.std()))
        print(f"[ pg ] epoch {epoch} mean reward: {rewards.mean():.4f}")
        metrics.log(
            epoch,
            phase="sample",
            mean_reward=float(rewards.mean()),
            std_reward=float(rewards.std()),
            n_samples=int(rewards.shape[0]),
            sample_time_s=float(sample_phase_time),
        )

        for name in ("rewards", "prompts", "callback_info"):
            np.save(
                fs.join_and_create(localpath, f"{name}/{worker_id}_{epoch}.npy"),
                samples[name],
            )
            if name != "rewards":
                del samples[name]

        # ============================ training phase =========================== #
        process_barrier(f"pg_train_{epoch}")
        comm_before, applies["n"] = comm_counts(), 0
        total_bs, num_timesteps = samples["log_probs"].shape
        assert num_timesteps == args.n_inference_steps
        num_train_ts = int(num_timesteps * args.train_timestep_ratio)
        keys = ["embeds", "latents", "next_latents", "log_probs", "ts", "advantages"]
        epoch_samples = {k: samples[k] for k in keys}
        epoch_samples["uncond_embeds"] = uncond_embed.expand(total_bs, *uncond_embed.shape)
        if resident and mesh.dp > 1:
            # the whole epoch's samples on every rank, in dp order (the
            # order of the gathered advantages)
            epoch_samples = {k: torch.cat(all_gather(v.contiguous(), mesh.axis("dp"),
                                                     "dp_samples"))
                             for k, v in epoch_samples.items()}
        for inner_epoch in range(args.num_inner_epochs):
            n_reduces = len(grad_reduce.calls) if grad_reduce is not None else 0
            timer()
            if resident:
                # drawn on the device from train_gen, the same on every
                # rank; each rank trains its dp rows of the global minibatch
                drawn = dict(generator=train_gen, dp=(mesh.dp, mesh.dp_index),
                             train_batch_size=train_bs * mesh.dp)
            else:
                # this rank's rows: the row and per-sample timestep
                # permutations from numpy's global stream
                perm = torch.as_tensor(np.random.permutation(total_bs), device=device)
                perms = torch.as_tensor(
                    np.stack([np.random.permutation(num_timesteps) for _ in range(total_bs)]),
                    device=device,
                )
                drawn = dict(perm=perm, t_perms=perms, train_batch_size=train_bs)
            epoch_fn = inner_epoch_resident if resident or fused else inner_epoch_per_timestep
            with batch_invariant():
                state, infos = epoch_fn(state, epoch_samples, num_train_ts=num_train_ts,
                                        **drawn, **epoch_kwargs)
            train_time = timer()
            n_batches = total_bs // train_bs
            # the global batch's infos: the mean of the dp slices' (equal
            # rows; the sp and tp ranks of a slice hold the same infos)
            infos = {k: worker_sum(v.double().cpu().numpy(), group=mesh.dp_group) / mesh.dp
                     for k, v in infos.items()}
            all_processes_equal(infos, "train infos")
            n_updates = n_batches * num_train_ts
            print(
                f"[ pg ] epoch {epoch}.{inner_epoch}{' (resident)' if resident else ''}: "
                f"loss {infos['loss'].mean():.5f} | kl {infos['approx_kl'].mean():.2e} "
                f"| clipfrac {infos['clipfrac'].mean():.3f} | {train_time:.2f}s, "
                f"{train_time / n_updates:.4f} s an update ({n_updates})"
            )
            if grad_reduce is not None:
                calls = grad_reduce.calls[n_reduces:]
                print(f"[ pg ] gradient all-reduce ({backend}, {args.grad_reduce_dtype}): "
                      f"{len(calls)} calls, {calls[0][0] if calls else 0} bytes each, "
                      "seconds " + ", ".join(f"{sec:.4f}" for _, sec in calls))
            metrics.log(
                epoch,
                phase="train",
                inner_epoch=inner_epoch,
                loss=float(infos["loss"].mean()),
                approx_kl=float(infos["approx_kl"].mean()),
                clipfrac=float(infos["clipfrac"].mean()),
                train_time_s=float(train_time),
            )
            if rank == 0:
                np.save(
                    fs.join_and_create(localpath,
                                       f"train_info/{worker_id}_{epoch}_{inner_epoch}.npy"),
                    infos,
                )
        if mesh.tp > 1 or (mesh.sp > 1 and not sp_spatial):
            # per call, from this epoch's counts: a sampler UNet forward, and
            # a trainer apply (its forward, the remat recompute and the
            # backward); the attention mode's VAE decode is in neither
            fwd = json.dumps(_per_call(sampler_comm, sample_calls["n"]), sort_keys=True)
            apply = json.dumps(_per_call(_comm_since(comm_before), applies["n"]), sort_keys=True)
            print(f"[ pg ] rank {rank}: {'tp' if mesh.tp > 1 else 'sp'} collectives a sampler "
                  f"UNet forward {fwd} | a trainer apply {apply} "
                  f"(calls, bytes, seconds; {sample_calls['n']} sampler forwards, "
                  f"{applies['n']} trainer applies)")
        profiling.close()
        if world > 1:
            d = all_processes_equal(state.global_params(), f"params after epoch {epoch}")
            print(f"[ pg ] epoch {epoch} params digest {d} (equal on all {world} ranks)")
            if mesh.tp > 1:
                whole = {k: p for k, p in state.params.items() if not tp_layout.sharded(k)}
                d = all_processes_equal(whole, f"replicated params after epoch {epoch}")
                print(f"[ pg ] epoch {epoch} replicated params digest {d} ({len(whole)} "
                      f"tensors, bit-equal on all {world} ranks)")
            # a SIGTERM seen by any rank stops every rank at this boundary
            shutdown_requested["flag"] = worker_sum(float(shutdown_requested["flag"])) > 0
        epochs_end, leave = time.perf_counter(), StepTimer()

        # ============================ checkpointing ============================ #
        saved = (
            (epoch + 1) % args.save_freq == 0
            or epoch == args.num_train_epochs - 1
            or shutdown_requested["flag"]
        )
        if saved:
            # the host copy is synchronous (training updates the tensors in
            # place); serialization and the disk write overlap the next epoch
            with leave.phase("checkpoint_copy"):
                save_train_state(
                    ckpt_root, epoch, {"state": state.state_dict(), "epoch": epoch},
                    host_state=host_checkpoint_state(), block=False,
                )
            if args.keep_checkpoints > 0 and rank == 0:  # the ranks share the directory
                prune_checkpoints(ckpt_root, args.keep_checkpoints)

        if rank == 0:
            _plot_rewards(mean_rewards, std_rewards, localpath, worker_id)
            with open(os.path.join(localpath, "reward_curve.json"), "w") as f:
                json.dump({"mean": mean_rewards, "std": std_rewards}, f)

        if remote:
            # durable artifacts: join the checkpoint writes, then stream
            # everything under localpath to the bucket (rank 0, in the
            # background); every other rank uploads its own host pickle
            with leave.phase("checkpoint_write"):
                wait_for_pending_saves()
            with leave.phase("bucket_sync"):
                if saved and rank > 0:
                    own = host_file(os.path.join(ckpt_root, "checkpoints", str(epoch)))
                    fs.put_file(own, os.path.join(args.savepath,
                                                  os.path.relpath(own, localpath)))
                if sync_thread is not None:
                    sync_thread.join()
                sync_thread = async_to_bucket(localpath, args.savepath)

        print(f"[ pg ] epoch {epoch} wall {time.perf_counter() - epoch_start:.2f} s")
        if shutdown_requested["flag"]:
            print(f"[ pg ] graceful shutdown after epoch {epoch} (checkpointed)")
            break

    if prev_sigterm is not None:
        signal.signal(signal.SIGTERM, prev_sigterm)
    set_attention_sharding(None)
    if mesh.sp > 1 or mesh.tp > 1:
        print(f"[ pg ] rank {rank}: {'sp' if mesh.sp > 1 else 'tp'} collectives (calls, bytes, "
              f"seconds) {json.dumps(comm_counts(), sort_keys=True)}")
    if lora_base is not None:
        # the merged UNet in the reference format, for generate --iteration
        # (the adapters alone stay in the full-state checkpoints)
        with leave.phase("lora_export"):
            with torch.no_grad():
                merged = merge_lora(lora_base, state.params)
            path = save_unet(localpath, unet, epoch=args.num_train_epochs - 1, params=merged)
        print(f"[ pg ] lora: merged unet exported to {path}")
    executor.shutdown()
    with leave.phase("checkpoint_write"):
        wait_for_pending_saves()
    if remote:
        with leave.phase("bucket_sync"):
            if sync_thread is not None:
                sync_thread.join()
            async_to_bucket(localpath, args.savepath, wait=True)  # the final full sync
    if device.type == "cuda":
        from ddpo_torch.ops._build import launch_counts

        print(f"[ pg ] rank {rank}: peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB | kernel launches "
              f"{json.dumps(launch_counts(), sort_keys=True)}")
    _print_timeline(rank, entered, before_main, boot, first_epoch_start, epochs_end, leave)
    return mean_rewards


def _print_timeline(rank, entered, before_main, boot, first_epoch_start, epochs_end, leave):
    """This run's ``launch_timeline`` as one JSON line: the epochs are the
    work, the checkpoint's host copy, its write's join and the bucket sync
    the exit's parts; with rank 0's last checkpoint (bytes, its copy's and
    write's seconds) and the JPEG library's first load."""
    from ddpo_torch.native import jpeg

    now = time.perf_counter()
    first = first_epoch_start if first_epoch_start is not None else now
    timeline = launch_timeline(entered, before_main, boot, first,
                               epochs_end if epochs_end is not None else first, leave)
    timeline["checkpoint"] = {k: last_save.get(k) for k in ("bytes", "copy_s", "write_s")}
    timeline["jpeg_library"] = jpeg.load_seconds
    print(f"[ pg ] rank {rank}: launch timeline (s) {json.dumps(timeline)}", flush=True)


def _comm_since(before: dict) -> dict:
    """The collectives (ops/spatial.py ``COMM``: calls, bytes, seconds by
    kind) since ``comm_counts()`` gave ``before``."""
    now = comm_counts()
    zero = (0, 0, 0.0)
    delta = {k: tuple(a - b for a, b in zip(v, before.get(k, zero))) for k, v in now.items()}
    return {k: v for k, v in delta.items() if v[0]}


def _comm_sum(a: dict, b: dict) -> dict:
    """Two ``_comm_since`` results added kind by kind."""
    zero = (0, 0, 0.0)
    return {k: tuple(x + y for x, y in zip(a.get(k, zero), b.get(k, zero)))
            for k in sorted(set(a) | set(b))}


def _per_call(comm: dict, calls: int) -> dict:
    """``comm`` over ``calls`` calls: (collectives, bytes, seconds) a call."""
    return {k: (c / calls, b / calls, round(sec / calls, 6))
            for k, (c, b, sec) in comm.items() if calls}


def _concat(batches):
    """Concatenate a list of sample batches leaf by leaf (tensors on their
    device, arrays with numpy, dicts key by key)."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _concat([b[k] for b in batches]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.cat(batches)
    return np.concatenate(batches)


def _plot_rewards(mean_rewards, std_rewards, localpath, worker_id):
    try:
        import matplotlib
    except ImportError:
        print("[ pg ] matplotlib is not installed: log_0.png skipped "
              "(reward_curve.json has the curve)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.clf()
    mean, std = np.array(mean_rewards), np.array(std_rewards)
    plt.plot(mean, color="black")
    plt.fill_between(range(len(mean)), mean - std, mean + std, alpha=0.4, color="blue")
    plt.savefig(os.path.join(localpath, f"log_{worker_id}.png"))
    plt.close()


if __name__ == "__main__":
    main()
    destroy_distributed()
