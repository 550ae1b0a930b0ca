from ddpo_torch.core.scheduler import DDIMScheduler, DDIMState, DDPMScheduler, make_betas

__all__ = ["DDIMScheduler", "DDIMState", "DDPMScheduler", "make_betas"]
