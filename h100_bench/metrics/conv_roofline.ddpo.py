"""The convolutions (the UNet's and the VAE decoder's, 3x3 and 1x1) as a
share of their roofline: the least time for the window's convolution work
(work.py: in the trainer with the remat recompute) over the device time of
the tap-GEMM family (its kernels and its weight-layout passes) and the convs
family (cuDNN's convs and the NCHW/NHWC conversions a library conv pays), in
percent. From the traced run."""


def read(run):
    if run.trace is None:
        return None
    spent = sum(run.trace["by_family"].get(f, 0.0) for f in ("tap-GEMM", "convs"))
    if spent <= 0:
        return None
    return 100.0 * run.work.conv_bound_s * run.epochs / spent
