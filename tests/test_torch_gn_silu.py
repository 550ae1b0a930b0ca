"""The port's fused GroupNorm+SiLU op against ddpo_tpu's, on the CPU.

The same numpy inputs (fp32, from a seed) go through JAX's
``group_norm_silu(use_kernel=True)``, its Pallas kernel in interpret mode as
tests/test_ops.py runs it, and the port's ``group_norm_silu(use_kernel=True)``,
whose CPU path is the kernel's plain version. Tolerance rtol 1e-4, atol 1e-5,
the bound tests/test_ops.py holds JAX's kernel to against XLA (fp32 sums in
another order). The CUDA kernel is held against the plain version on the
card by tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.ops import _build
from ddpo_torch.ops.groupnorm import group_norm, group_norm_silu, group_norm_silu_reference
from ddpo_tpu.ops.groupnorm import group_norm_silu as jax_group_norm_silu


def _inputs(shape, seed):
    """NHWC x, scale and bias in fp32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, **kw):
    out = group_norm_silu(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                          torch.from_numpy(scale), torch.from_numpy(bias), **kw)
    return out.permute(0, 2, 3, 1).numpy()


# tests/test_ops.py's shape, and one whose 3x8 map is odd in NCHW
@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (1, 3, 8, 256)])
def test_gn_silu_matches_jax_kernel(shape):
    x, scale, bias = _inputs(shape, seed=shape[1])
    ref = jax_group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              num_groups=32, use_kernel=True, interpret=True)
    out = _port(x, scale, bias, num_groups=32, use_kernel=True)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c", [48, 20])  # gcd clamp: 16 and 4 groups
def test_gn_silu_unsplit_channels_take_group_norm(c):
    """Channels that do not split into the groups take group_norm in both
    packages, with its gcd clamp, whatever use_kernel says."""
    x, scale, bias = _inputs((2, 8, 8, c), seed=c)
    ref = jax_group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              use_kernel=True, interpret=True)
    out = _port(x, scale, bias, use_kernel=True)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)
    t = [torch.from_numpy(a) for a in (x, scale, bias)]
    xt = t[0].permute(0, 3, 1, 2).contiguous()
    assert torch.equal(group_norm_silu(xt, t[1], t[2], use_kernel=True),
                       group_norm(xt, t[1], t[2], silu=True))


def test_gn_silu_default_and_cpu_path_never_touch_the_kernel(monkeypatch):
    """use_kernel None is group_norm(silu=True), as in JAX; use_kernel=True
    on a CPU tensor is group_norm(silu=True) too, equal to the kernel's plain
    version; neither loads the kernel library or counts a launch."""
    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = _build.launch_counts()
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 64), seed=1))
    x = x.permute(0, 3, 1, 2).contiguous()
    assert torch.equal(group_norm_silu(x, scale, bias), group_norm(x, scale, bias, silu=True))
    fused = group_norm_silu(x, scale, bias, use_kernel=True)
    assert torch.equal(fused, group_norm_silu_reference(x, scale, bias))
    torch.testing.assert_close(fused, group_norm(x, scale, bias, silu=True), rtol=0, atol=0)
    assert _build.launch_counts() == before
