"""The UNet's self-attention as a share of its roofline: the least time the
card could take for the window's self-attention products (work.py: the
forward in the sampler; the forward, its remat recompute and the backward
in the trainer) over the device time of the kernels in the attention family,
in percent. From the traced run. The family holds the flash kernels; the
cross-attention and the VAE's and text encoder's attention take the plain
path (GEMMs, softmax) and are on neither side, and the mid block's 64-token
self-attention, about 0.1% of the counted work, takes it too but is counted."""


def read(run):
    if run.trace is None:
        return None
    spent = run.trace["by_family"].get("attention", 0.0)
    if spent <= 0:
        return None
    return 100.0 * run.work.attn_bound_s * run.epochs / spent
