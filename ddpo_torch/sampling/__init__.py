from ddpo_torch.sampling.sampler import (
    SamplerConfig,
    sample_images,
    sample_images_ode,
    sample_trajectories,
    vae_decode,
)

__all__ = ["SamplerConfig", "sample_images", "sample_images_ode", "sample_trajectories",
           "vae_decode"]
