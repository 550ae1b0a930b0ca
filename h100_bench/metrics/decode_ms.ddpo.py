"""Milliseconds an epoch in ``vae_decode`` and the images' copy to the host."""


def read(run):
    return 1e3 * run.spans.total("decode", since=run.start) / run.epochs
