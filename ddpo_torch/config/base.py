"""Experiment configuration: defaults per experiment kind + named datasets.

Public surface matches the reference's config/base.py: the same four
experiment blocks (sample / sizes / train / pg), the same named dataset
configs (compressed_animals, neg_compressed_animals, *_rwr, vqa_v0,
llava_vqa, llava_counting, llava_bertscore, a_dog_1/2, a_animals[_rwr],
*_nocfg), and the same three-level merge semantics handled by
ddpo_torch.utils.parser (base[experiment] <- dataset["common"] <-
dataset[experiment] <- CLI extras). Values are the reference defaults
(config/base.py:3-103) unless noted.

Deferred paths use the same "f:" lazy f-string convention so RWR iterations
chain ("f:models/{iteration+1}").

This is the PyTorch port's copy of ddpo_tpu/config/base.py: every preset and
value is unchanged, so one command line means the same run in both packages.
One key is the port's own: ``device`` in the sample, train, generate and pg
blocks.
Every measurement a comment below cites was taken by the JAX package on a
TPU v5e; none of them describes this port's speed.
"""

from ddpo_torch.config import user

base = {
    # data collection for RWR (pipelines/sample.py)
    "sample": {
        "loadpath": "f:models/{iteration}",
        "savepath": "f:samples/{iteration}",
        "load_epoch": "latest",
        "n_samples_per_device": 4,
        "pretrained_model": "duongna/stable-diffusion-v1-4-flax",
        "prompt_kwargs": {},
        "n_inference_steps": 50,
        # "ddim" (reference parity) or "dpm++": DPM-Solver++(2M) — RWR
        # collection keeps only images+rewards, so the deterministic
        # few-step solver applies; measured 2.38x DDIM-50 throughput at
        # closer-than-DDIM-20 endpoint quality (bench_dpm.py). Pair with
        # --n_inference_steps 20.
        "scheduler": "ddim",
        # "int8": W8A8 quantized resnet convs in the sampling UNet
        # (2x-rate MXU path, ops/quant.py) — inference-only speedup for
        # data collection; the stored images/latents are what trains, so
        # quantization shifts sample statistics slightly but nothing else
        "quant": "none",
        "eta": 1.0,
        "resolution": 512,
        "max_samples": 50e3,
        "max_steps": None,
        "local_size": 1600,
        "guidance_scale": 5.0,
        "filter_field": "labels",
        "mask_mode": "streaming_percentile",
        "mask_param": 95,
        "identical_batch": False,
        "iteration": 0,
        "evaluate": False,
        "cache": "cache",
        "seed": None,
        "dtype": "bfloat16",
        "model_preset": "sd14",  # TPU-native default (reference used float32)
        "device": "cuda",  # or "cpu"; "cuda" raises when there is no card
    },
    # guidance-scale calibration sweep (pipelines/calibrate.py). Completes
    # the loop the reference left external: it only *consumes* a calibrated
    # scale (pipeline/sample.py:48-49 reads metadata.json via
    # load_guidance_scale); this block produces that metadata.json.
    "calibrate": {
        "loadpath": "f:models/{iteration}",
        "savepath": "f:models/{iteration}",
        "load_epoch": "latest",
        "pretrained_model": "duongna/stable-diffusion-v1-4-flax",
        "prompt_kwargs": {},
        "n_samples_per_device": 4,
        "n_inference_steps": 50,
        "eta": 1.0,
        "resolution": 512,
        "guidance_scales": None,  # None -> [1, 2, 3, 5, 8, 12]
        "n_eval_batches": 1,
        "identical_batch": False,
        "iteration": 0,
        "evaluate": True,
        "cache": "cache",
        "seed": None,
        "dtype": "bfloat16",
        "model_preset": "sd14",
    },
    # generation-only inference (pipelines/generate.py). No reference
    # counterpart as a standalone driver — the reference previews samples
    # only inside the PG loop (pipeline/policy_gradient.py:300-305); users
    # of a finetuned checkpoint need a way to just make images.
    "generate": {
        "loadpath": "f:models/{iteration}",
        "savepath": "f:generations/{iteration}",
        "load_epoch": "latest",
        "pretrained_model": "duongna/stable-diffusion-v1-4-flax",
        "prompt_kwargs": {},
        "prompts": None,  # explicit list overrides prompt_fn
        "n_samples": 8,
        "n_samples_per_device": 4,
        "n_inference_steps": 50,
        "scheduler": "ddim",  # or "dpm++": DPM-Solver++(2M), ~20 steps enough
        "quant": "none",  # "int8": W8A8 resnet convs (ops/quant.py)
        "eta": 1.0,
        "resolution": 512,
        "guidance_scale": 5.0,  # or "auto" -> loadpath/metadata.json
        "grid": True,  # also save one grid png per batch
        "identical_batch": False,
        "iteration": 0,
        "evaluate": True,
        "cache": "cache",
        "seed": None,
        "dtype": "bfloat16",
        "model_preset": "sd14",
        # the port's counterpart of JAX_PLATFORMS: "cuda" (the kernels'
        # device, raising when there is no card) or "cpu"
        "device": "cuda",
    },
    # sizes manifest builder (pipelines/save_sizes.py)
    "sizes": {
        "loadpath": "f:samples/{iteration}",
        "iteration": 0,
    },
    # RWR supervised finetuning (pipelines/finetune.py). lora_rank as in
    # the pg block: 0 = full finetune, >0 = rank-r attention adapters.
    "train": {
        "lora_rank": 0,
        "modelpath": "f:models/{iteration}",
        "loadpath": "f:samples/{iteration}",
        "savepath": "f:models/{iteration+1}",
        "pretrained_model": "duongna/stable-diffusion-v1-4-flax",
        "finetuned_model": None,
        "load_epoch": "latest",
        "max_train_samples": None,
        "resolution": 512,
        "train_cfg": False,
        "guidance_scale": 5.0,
        "train_batch_size": 2,
        "num_train_epochs": 40,
        "max_train_steps": None,
        "learning_rate": 1e-5,
        "lr_schedule": "constant",  # | "linear" | "cosine" (see pg block)
        "lr_warmup_steps": 0,
        "lr_total_steps": None,
        "beta1": 0.9,
        "beta2": 0.999,
        "weight_decay": 1e-4,
        "epsilon": 1e-8,
        "max_grad_norm": 1.0,
        "iteration": 0,
        "weighted_batch": False,
        "weighted_dataset": False,
        "temperature": 1.0,
        "per_prompt_weights": False,
        "dtype": "float32",
        "cache": "cache",
        "verbose": False,
        "save_freq": 100,
        "seed": 0,
        "model_preset": "sd14",
        "num_workers": 2,  # prefetch threads in the data loader
        "remat": True,  # rematerialize UNet activations in the backward
        "device": "cuda",  # or "cpu"; "cuda" raises when there is no card
    },
    # DDPO policy-gradient training (pipelines/policy_gradient.py)
    "pg": {
        "loadpath": "",
        "load_epoch": "latest",
        "modelpath": "models/pg",
        "savepath": "f:models/pg",
        "pretrained_model": "duongna/stable-diffusion-v1-4-flax",
        "resolution": 512,
        "filter_field": None,
        "guidance_scale": 5.0,
        "dtype": "float32",  # master param/optimizer dtype (keep fp32:
        # bf16 weights cannot absorb lr~1e-5 adamw updates)
        "cache": "cache",
        "verbose": False,
        "seed": 0,
        "iteration": 0,
        # sampling phase
        "sample_batch_size": 8,  # per device
        "num_sample_batches_per_epoch": 1,
        "n_inference_steps": 50,
        "identical_batch": False,
        "evaluate": False,
        "eta": 1.0,
        # training phase
        "train_batch_size": 2,  # per device
        "train_accumulation_steps": 1,
        "num_train_epochs": 200,
        "num_inner_epochs": 1,
        # reference value is 1e-4 (config/base.py:84). Measured on v5e at
        # production geometry (bench_logp.py, round 3): the recompute-noise
        # median |dlogp| is 4.5e-5 for fp32 and 9.0e-5 for bf16 — the
        # reference's own clip range sits at ~0.5x/1x its numerics noise
        # (clipfrac 0.19 / 0.46 at sampling params). 2e-4 restores the
        # reference's noise-to-trust-region ratio under the bf16 defaults.
        "ppo_clip_range": 2e-4,
        "train_cfg": True,
        # 0 = full finetune (reference behavior). >0 trains rank-r LoRA
        # adapters on the attention projections only (models/lora.py).
        # Measured at r=8 on v5e (bench_lora.py, round 4): train state
        # 180x smaller (18.2 vs 3286 MB — checkpoints + dp all-reduces),
        # trainable 537x smaller, step 1.25x FASTER than full finetune.
        # lr is MEASURED, not folklore (40-epoch real-chip curves,
        # BENCHLOG round 4): at r=8, lr=1e-4 barely moves the policy
        # (kl ~2e-6, best reward -217.6); lr=1e-3 learns PAST the
        # full-finetune curve (best -189.7 vs -207.3) and stays stable
        # (kl <= 1.8e-3, clipfrac <= 0.18). Use --learning_rate 1e-3
        # with --lora_rank 8.
        "lora_rank": 0,
        "learning_rate": 1e-5,
        # "constant" (reference) | "linear" | "cosine"; warmup in optimizer
        # steps; decaying schedules need --lr_total_steps (the horizon)
        "lr_schedule": "constant",
        "lr_warmup_steps": 0,
        "lr_total_steps": None,
        "beta1": 0.9,
        "beta2": 0.999,
        "weight_decay": 1e-4,
        "epsilon": 1e-8,
        "max_grad_norm": 1.0,
        "save_freq": 10,
        "optimizer": "adamw",
        # "none" (reduce grads at the param dtype — fp32 masters, the
        # reference's pmean semantics) | "bfloat16" | "float32". bfloat16
        # halves the dp all-reduce bytes (compile-measured:
        # bench_grad_reduce.py) — matters most on DCN multi-slice where
        # the reduce rides ~25 GB/s. Off by default pending a multi-slice
        # learning-parity run at scale; per-step numerics pinned by
        # tests/test_grad_reduce.py.
        "grad_reduce_dtype": "none",
        "train_timestep_ratio": 1.0,
        "prompt_kwargs": {},
        "per_prompt_stats_bufsize": 32,
        "per_prompt_stats_min_count": 16,
        # TPU-native extensions (not in the reference)
        "fused_train_loop": True,  # scan over timesteps in one dispatch
        # (equivalence-tested vs per-timestep dispatch; 1.8x on v5e)
        # Full inner epoch on device (one dispatch: shuffle + rebatch +
        # minibatch scan) vs the host loop (numpy shuffle + one dispatch
        # per minibatch). Measured a WASH at production geometry (v5e,
        # bs8 T50 512px train_bs2: 35.3s resident vs 35.5s host, 1.006x
        # — bench_resident.py, round 4; measured under --optimizer
        # adafactor, the choice that fits both loops' state in HBM at
        # that geometry — the pg default stays adamw): 4 dispatches of
        # ~9s each leave nothing for dispatch overhead to save. Host loop stays the
        # default for its simpler failure surface and per-minibatch
        # host-visible infos; the resident path remains available and
        # equivalence-tested for geometries with many small minibatches.
        "resident_inner_loop": False,
        "mesh_tp": 1,  # tensor-parallel axis size
        "mesh_sp": 1,  # sequence-parallel axis size (latent self-attention)
        # "spatial": whole-UNet shard_map, H sharded — halo-exchange convs
        #   divide conv FLOPs by sp AND move 8.1x less sp-axis traffic in
        #   the train step (441 vs 3582 MB/step at 512px on a dp4xsp2 mesh;
        #   forward ~equal at 193 vs 203 MB — bench_sp_comms.py, compile-
        #   measured HLO collective bytes, round 4);
        # "attention": per-attention shard_map only — convs stay REPLICATED
        #   over sp (duplicated FLOPs, no conv speedup), and the param-grad
        #   reduction pays an extra sp-axis all-reduce. Kept as the fallback
        #   for geometries the spatial mode's divisibility check rejects.
        "sp_mode": "spatial",
        # Compute dtypes (master params/optimizer stay in `dtype`=fp32).
        # bf16 is the measured-sound default: on v5e at production geometry
        # the bf16 sampler is 1.14x and the bf16 fused train step 1.83x,
        # while the PPO-ratio noise it adds is only 2x the fp32 floor
        # (median |dlogp| 9.0e-5 vs 4.5e-5 — bench_logp.py round 3; the
        # round-1 "~1e-2 bf16 noise" predates the fp32 latent carry and is
        # not reproducible). ppo_clip_range above is retuned accordingly.
        "sample_dtype": "bfloat16",  # sampler compute dtype
        "train_dtype": "bfloat16",  # PPO-recompute compute dtype
        "profile_dir": None,  # jax.profiler trace output
        "resume": False,  # restore full train state from savepath
        # keep only the newest N full-state checkpoints on local disk
        # (~8.5GB each at SD scale); 0 = keep all (reference behavior,
        # keep=1e6 at pipeline/policy_gradient.py:461). Remote copies
        # already synced to the bucket are never deleted.
        "keep_checkpoints": 0,
        "model_preset": "sd14",  # "tiny" for CPU smoke tests
        "remat": True,  # rematerialize UNet activations in the PPO backward
        "device": "cuda",  # or "cpu"; "cuda" raises when there is no card
    },
}


def _dataset(logdir, prompt_fn, filter_field, prompt_kwargs=None,
             sample=None, train=None, pg=None, calibrate=None, generate=None):
    cfg = {
        "common": {
            "logbase": f"{user.bucket}/logs/{logdir}",
            "prompt_fn": prompt_fn,
            "filter_field": filter_field,
        },
        "sample": sample or {},
        "train": train or {},
        "pg": pg or {},
        "calibrate": calibrate or {},
        "generate": generate or {},
    }
    if prompt_kwargs is not None:
        cfg["common"]["prompt_kwargs"] = prompt_kwargs
    return cfg


_FILTER_SAMPLE = {  # top-decile filtering for sparse RWR
    "max_samples": 1024,
    "mask_mode": "percentile",
    "mask_param": 90,
    "identical_batch": True,
}
_KEEPALL_SAMPLE = {  # keep everything; weights come from softmax at train time
    "max_samples": 10240,
    "mask_mode": "streaming_percentile",
    "mask_param": 0,
    "identical_batch": False,
}


compressed_animals = _dataset(
    "identical-compressed-animals-s1024-p90", "imagenet_animals", "jpeg",
    sample=dict(_FILTER_SAMPLE),
    train={"train_cfg": True, "train_batch_size": 4, "num_train_epochs": 50,
           "save_freq": 20, "dtype": "float32"},
)

# Measured-best DDPO recipe on the flagship task (no reference equivalent):
# LoRA r=8 @ lr 1e-3 adamw. 40-epoch real-chip curves (BENCHLOG round 4)
# show it learns PAST full finetune (best reward -189.7 vs -207.3) with a
# 1.25x faster train step (73.7 vs 91.9 ms), 537x fewer trainables, and a
# 180x smaller train state (checkpoints + dp all-reduce traffic).
compressed_animals_lora = _dataset(
    "lora-compressed-animals-r8", "imagenet_animals", "jpeg",
    sample=dict(_FILTER_SAMPLE),
    pg={"lora_rank": 8, "learning_rate": 1e-3},
)

neg_compressed_animals = _dataset(
    "identical-neg-compressed-animals-s1024-p90", "imagenet_animals", "neg_jpeg",
    sample=dict(_FILTER_SAMPLE),
    train={"train_cfg": True, "train_batch_size": 1, "num_train_epochs": 50,
           "save_freq": 20, "dtype": "float32"},
)

compressed_animals_rwr = _dataset(
    "rwr-compressed-animals-s10k", "imagenet_animals", "jpeg",
    sample=dict(_KEEPALL_SAMPLE),
    train={"train_cfg": True, "train_batch_size": 1, "num_train_epochs": 5,
           "save_freq": 20, "dtype": "float32", "weighted_dataset": True,
           "temperature": 1 / 5.0},
)

neg_compressed_animals_rwr = _dataset(
    "rwr-neg-compressed-animals-s10k", "imagenet_animals", "neg_jpeg",
    sample=dict(_KEEPALL_SAMPLE),
    train={"train_cfg": True, "train_batch_size": 1, "num_train_epochs": 5,
           "save_freq": 20, "dtype": "float32", "weighted_dataset": True,
           "temperature": 1 / 5.0},
)

vqa_v0 = _dataset(
    "vqa-v0-n2k-s5.0-e50", "vqa_dataset", "vqa",
    prompt_kwargs={"loadpath": "assets/vqa_v0.txt"},
    sample={"max_samples": 2e3, "mask_mode": "threshold", "mask_param": 0.65,
            "identical_batch": False},
    train={"train_cfg": True, "train_batch_size": 1, "num_train_epochs": 50,
           "save_freq": 20},
)

llava_vqa = _dataset(
    "llava-vqa-v2", "vqa_dataset", "llava_vqa",
    prompt_kwargs={"loadpath": "assets/vqa_v2.txt"},
    pg={"per_prompt_stats_bufsize": 128, "per_prompt_stats_min_count": 32,
        "num_train_epochs": 120},
)

llava_counting = _dataset(
    "llava-counting-v0-8", "counting", "llava_vqa",
    prompt_kwargs={"nouns_path": "assets/very_simple_animals.txt",
                   "number_range": (2, 8)},
)

llava_bertscore = _dataset(
    "llava-bertscore-2-simple-animals", "nouns_activities", "llava_bertscore",
    prompt_kwargs={"nouns_path": "assets/common_animals.txt",
                   "activities_path": "assets/activities_v0.txt"},
)

a_dog_1 = _dataset(
    "aesthetic_dogs_sweep/one", "manual", "aesthetic",
    prompt_kwargs={"prompts": ["a dog"]},
    pg={"per_prompt_stats_bufsize": None, "per_prompt_stats_min_count": None,
        "train_batch_size": 1, "train_accumulation_steps": 2},
)

a_dog_2 = _dataset(
    "aesthetic_dogs_sweep/imagenet", "imagenet_dogs", "aesthetic",
    prompt_kwargs={},
    pg={"train_batch_size": 1, "train_accumulation_steps": 2},
)

a_animals = _dataset(
    "aesthetic_simple_animals", "from_file", "aesthetic",
    prompt_kwargs={"loadpath": "assets/common_animals.txt"},
    sample=dict(_FILTER_SAMPLE),
    train={"train_cfg": True, "train_batch_size": 1, "num_train_epochs": 50,
           "save_freq": 20, "dtype": "float32"},
    pg={"train_batch_size": 1, "train_accumulation_steps": 2},
)

a_animals_rwr = _dataset(
    "aesthetic_simple_animals_rwr_ppb", "from_file", "aesthetic",
    prompt_kwargs={"loadpath": "assets/common_animals.txt"},
    sample=dict(_KEEPALL_SAMPLE),
    train={"train_cfg": True, "train_batch_size": 4, "num_train_epochs": 5,
           "save_freq": 10000000, "dtype": "float32", "weighted_dataset": True,
           "temperature": 1 / 5.0, "per_prompt_weights": True},
)

compressed_animals_nocfg = _dataset(
    "nocfg-compressed-animals-s1024-p90", "imagenet_animals", "jpeg",
    sample=dict(_FILTER_SAMPLE),
    train={"train_cfg": False, "train_batch_size": 2, "num_train_epochs": 50,
           "save_freq": 20, "dtype": "float32"},
)

neg_compressed_animals_nocfg = _dataset(
    "nocfg-neg-compressed-animals-s1024-p90", "imagenet_animals", "neg_jpeg",
    sample=dict(_FILTER_SAMPLE),
    train={"train_cfg": False, "train_batch_size": 2, "num_train_epochs": 50,
           "save_freq": 20, "dtype": "float32"},
)

# CPU/debug fixture: tiny everything, deterministic prompt, index reward.
debug_animals = _dataset(
    "debug-animals", "animal_debug", "arange",
    sample={"max_samples": 8, "mask_mode": "threshold", "mask_param": -1,
            "n_samples_per_device": 2, "n_inference_steps": 4,
            "resolution": 64, "local_size": 8},
    train={"train_batch_size": 1, "num_train_epochs": 1, "resolution": 64},
    pg={"sample_batch_size": 2, "train_batch_size": 1, "n_inference_steps": 4,
        "resolution": 64, "num_train_epochs": 2,
        "per_prompt_stats_bufsize": None, "per_prompt_stats_min_count": None},
    calibrate={"n_samples_per_device": 1, "n_inference_steps": 4,
               "resolution": 64, "guidance_scales": [1.0, 7.5]},
    generate={"n_samples_per_device": 1, "n_inference_steps": 4,
              "resolution": 64, "n_samples": 4},
)
debug_animals["common"]["model_preset"] = "tiny"
debug_animals["common"]["dtype"] = "float32"
debug_animals["common"]["sample_dtype"] = "float32"
debug_animals["common"]["train_dtype"] = "float32"  # bf16 is emulated on CPU
