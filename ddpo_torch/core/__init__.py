from ddpo_torch.core.scheduler import DDIMScheduler, DDIMState, make_betas

__all__ = ["DDIMScheduler", "DDIMState", "make_betas"]
