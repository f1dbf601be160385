"""ray_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the
``cuda_device`` fixture decides).  The file imports neither JAX nor
ray_tpu, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from ray_tpu_torch._device import disable_tf32
from ray_tpu_torch.ops import flash_attention as t_flash
from ray_tpu_torch.ops import layer_norm as t_ln


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card")
    disable_tf32()          # float32 comparisons stay in full float32
    return torch.device("cuda")


# 768: GPT-2 124M's width, the register-tile path; 1600: GPT-2 XL's,
# wider than the tile, the generic loop.
@pytest.mark.parametrize("N,E", [(1024, 768), (16, 768), (33, 1600)])
def test_layer_norm_kernel_matches_plain(cuda_device, N, E):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((N, E), generator=g, device=cuda_device)
    s = 1 + 0.1 * torch.randn(E, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(E, generator=g, device=cuda_device)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7 * 8)):
        y, mu, rstd = t_ln.ln_fwd(x.to(dt), s, b, 1e-5, want_stats=True)
        yp, mup, rstdp = t_ln.ln_fwd_plain(x.to(dt), s, b, 1e-5)
        torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=0)
        torch.testing.assert_close(mu, mup, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T", [64, 333, 1024])
def test_flash_kernel_matches_plain(cuda_device, T):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((1, T, 3, 768), generator=g, device=cuda_device)
    q, k, v = [qkv[:, :, i].unflatten(-1, (12, 64)) for i in range(3)]
    for causal in (True, False):
        out, lse = t_flash.flash_attention(q, k, v, causal, want_lse=True)
        ref, rlse = t_flash.flash_attention_plain(q, k, v, causal, True)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-4)
