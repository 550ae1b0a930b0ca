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
One key is the port's own: ``device`` in the sample, calibrate, train,
generate and pg blocks. The numbers in the comments below are the port's,
measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
limit.
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
        # few-step solver applies. Pair with --n_inference_steps 20.
        "scheduler": "ddim",
        # "int8": W8A8 quantized resnet convs in the sampling UNet
        # (ops/quant.py, the s8 tap-GEMM kernel on the card) — inference
        # only; the stored images are what trains, so quantization shifts
        # sample statistics slightly but nothing else
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
        "model_preset": "sd14",
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
        "device": "cuda",  # or "cpu"; "cuda" raises when there is no card
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
        # reference value is 1e-4 (config/base.py:84); JAX's default, kept
        # so one command line means one run. On the card the bf16
        # recompute gives |dlogp| 0 at the sampler's shape and at most
        # 4.0e-7 at the trainer's (chip_smoke.py phases 6-9), far inside it.
        "ppo_clip_range": 2e-4,
        "train_cfg": True,
        # 0 = full finetune (reference behavior). >0 trains rank-r LoRA
        # adapters on the attention projections only (models/lora.py). At
        # r=8 on the card: 1,594,368 trainables, 0.388-0.391 s an update
        # against 0.480-0.497 full (chip_smoke.py phase 9). Use
        # --learning_rate 1e-3 with --lora_rank 8 (the lora preset).
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
        # reference's pmean semantics) | "bfloat16" | "float32": bfloat16
        # halves the data-parallel all-reduce bytes (fused loop only;
        # parallel/collectives.py GradientAllReduce).
        "grad_reduce_dtype": "none",
        "train_timestep_ratio": 1.0,
        "prompt_kwargs": {},
        "per_prompt_stats_bufsize": 32,
        "per_prompt_stats_min_count": 16,
        # JAX's own extensions (not in the reference)
        # all trained timesteps of a minibatch in one optimizer step (JAX's
        # scan over timesteps in one dispatch) instead of accumulating
        "fused_train_loop": True,
        # JAX: the full inner epoch on device (one dispatch: shuffle +
        # rebatch + minibatch scan) instead of the host loop (numpy shuffle
        # + one dispatch per minibatch); not ported, and refused.
        "resident_inner_loop": False,
        "mesh_tp": 1,  # tensor-parallel axis size
        "mesh_sp": 1,  # sequence-parallel axis size (latent self-attention)
        # "spatial": whole-UNet shard_map, H sharded — halo-exchange convs
        #   divide conv FLOPs by sp and move less sp-axis traffic;
        # "attention": per-attention shard_map only — convs stay REPLICATED
        #   over sp (duplicated FLOPs, no conv speedup), and the param-grad
        #   reduction pays an extra sp-axis all-reduce. Kept as the fallback
        #   for geometries the spatial mode's divisibility check rejects.
        "sp_mode": "spatial",
        # Compute dtypes (master params/optimizer stay in `dtype`=fp32).
        # bf16 by default, as in JAX; the on-policy recompute at bf16 is
        # exact or within 4.0e-7 on the card (ppo_clip_range above).
        "sample_dtype": "bfloat16",  # sampler compute dtype
        "train_dtype": "bfloat16",  # PPO-recompute compute dtype
        # torch.profiler trace of epoch start_epoch + 1, one Chrome trace per
        # rank (utils/profiling.py)
        "profile_dir": None,
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

# JAX's LoRA recipe on the flagship task (no reference equivalent): LoRA
# r=8 @ lr 1e-3 adamw, 1,594,368 trainables; on the card an update takes
# 0.78-0.82x the full finetune's (chip_smoke.py phase 9).
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
