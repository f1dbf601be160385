"""ray_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the
``cuda_device`` fixture decides).  The file imports neither JAX nor
ray_tpu, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from ray_tpu_torch import _build
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


def _within_bf16_steps(out, ref, steps):
    """``steps`` bf16 steps of each element.  Two for the backward
    (chip_smoke.py's FLASH_BWD_STEPS: the outputs sum terms rounded to
    bf16 at the reference's points), one for the forward."""
    r = ref.float()
    limit = steps * (2 ** -7 * r.abs()
                     + 4 * 2 ** -8 * r.pow(2).mean().sqrt())
    assert ((out.float() - r).abs() <= limit).all()


# (33, 1600): wider than the register tile, the generic loop; 333 rows:
# a ragged last stripe.
@pytest.mark.parametrize("N,E", [(1024, 768), (333, 768), (33, 1600)])
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, N, E):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((N, E), generator=g, device=cuda_device)
    gy = torch.randn((N, E), generator=g, device=cuda_device)
    s = 1 + 0.1 * torch.randn(E, generator=g, device=cuda_device)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7 * 8)):
        _, mu, rstd = t_ln.ln_fwd_plain(x.to(dt), s, torch.zeros_like(s))
        dx, ds, db = t_ln.ln_bwd(x.to(dt), s, gy.to(dt), mu, rstd)
        dxp, dsp, dbp = t_ln.ln_bwd_plain(x.to(dt), s, gy.to(dt), mu, rstd)
        assert dx.dtype == dt and ds.dtype == db.dtype == torch.float32
        torch.testing.assert_close(dx.float(), dxp.float(), atol=tol, rtol=0)
        # float32 sums of N terms of size ~1 in other orders
        torch.testing.assert_close(ds, dsp, atol=1e-6 * N, rtol=1e-5)
        torch.testing.assert_close(db, dbp, atol=1e-6 * N, rtol=1e-5)


@pytest.mark.parametrize("T", [64, 333])
def test_flash_bwd_kernel_matches_plain(cuda_device, T):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((2, T, 3, 768), generator=g, device=cuda_device)
    do = torch.randn((2, T, 12, 64), generator=g, device=cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = [qkv.to(dt)[:, :, i].unflatten(-1, (12, 64))
                   for i in range(3)]
        for causal in (True, False):
            out, lse = t_flash.flash_attention_plain(q, k, v, causal, True)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
                .reshape(-1, T)
            got = t_flash.flash_attention_bwd(q, k, v, lse, delta,
                                              do.to(dt), causal)
            ref = t_flash.flash_attention_bwd_plain(q, k, v, lse, delta,
                                                    do.to(dt), causal)
            for a, r in zip(got, ref):
                assert a.dtype == dt and a.is_contiguous()
                if dt == torch.float32:
                    torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)
                else:
                    _within_bf16_steps(a, r, 2)


def test_cuda_outputs_carry_grad_fn_and_backward_launches(cuda_device):
    """The regression test for outputs that autograd could not see: on a
    CUDA tensor that requires grad both ops return a Function's output,
    and backward launches the backward kernels."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((4, 64, 768), generator=g, device=cuda_device,
                    dtype=torch.bfloat16).requires_grad_()
    s = torch.ones(768, device=cuda_device, requires_grad=True)
    b = torch.zeros(768, device=cuda_device, requires_grad=True)
    before = (t_ln.bwd_launches, t_flash.bwd_launches)
    y = t_ln.layer_norm(x, s, b)
    assert isinstance(y.grad_fn, t_ln.LayerNormFn._backward_cls)
    q = y.view(4, 64, 12, 64)
    o = t_flash.flash_attention(q, q, q, True)
    assert isinstance(o.grad_fn, t_flash.FlashAttentionFn._backward_cls)
    o.float().sum().backward()
    torch.cuda.synchronize()
    assert (t_ln.bwd_launches, t_flash.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    for t in (x, s, b):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


# The bf16 tensor-core kernels.  T: one row, tiles of 64 and their ragged
# neighbours, the engine's ragged lengths, the longest bucket.
TC_LENGTHS = [1, 15, 63, 64, 65, 127, 129, 333, 1024]


def _bf16_qkv(dev, B, T, seed):
    """q, k, v as the model makes them: strided views of one qkv tensor."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, T, 3, 768), generator=g, device=dev)
    qkv = qkv.to(torch.bfloat16)
    return [qkv[:, :, i].unflatten(-1, (12, 64)) for i in range(3)]


@pytest.mark.parametrize("block_m", t_flash.BLOCK_MS)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", TC_LENGTHS)
def test_flash_tc_forward_matches_plain(cuda_device, T, B, block_m):
    q, k, v = _bf16_qkv(cuda_device, B, T, 4)
    for causal in (True, False):
        before = (t_flash.launches, t_flash.f32_launches)
        out, lse = t_flash._flash_kernel(q, k, v, causal, True, block_m)
        ref, rlse = t_flash.flash_attention_plain(q, k, v, causal, True)
        torch.cuda.synchronize()
        assert (t_flash.launches, t_flash.f32_launches) == \
            (before[0] + 1, before[1])
        assert out.dtype == torch.bfloat16
        _within_bf16_steps(out, ref, 1)
        # exp2/log2 approximations and summation order
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", TC_LENGTHS)
def test_flash_tc_backward_matches_plain(cuda_device, T, B):
    """delta is random, as in the CPU parity test (the kernel takes any
    delta).  With the real sum_D do * o, the exact dq and dk are zero at
    T = 1 (a softmax over one key is constant), and both versions return
    float32 cancellation noise of dp - delta, which no relative limit can
    hold; the real delta is held at T >= 64 above and in chip_smoke.py."""
    q, k, v = _bf16_qkv(cuda_device, B, T, 5)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    do = torch.randn((B, T, 12, 64), generator=g, device=cuda_device)
    do = do.to(torch.bfloat16)
    delta = torch.randn((B * 12, T), generator=g, device=cuda_device)
    for causal in (True, False):
        _, lse = t_flash.flash_attention_plain(q, k, v, causal, True)
        before = (t_flash.bwd_launches, t_flash.f32_bwd_launches)
        got = t_flash.flash_attention_bwd(q, k, v, lse, delta, do, causal)
        ref = t_flash.flash_attention_bwd_plain(q, k, v, lse, delta, do,
                                                causal)
        torch.cuda.synchronize()
        assert (t_flash.bwd_launches, t_flash.f32_bwd_launches) == \
            (before[0] + 1, before[1])
        for a, r in zip(got, ref):
            assert a.dtype == torch.bfloat16 and a.is_contiguous()
            _within_bf16_steps(a, r, 2)


def _misaligned(dev, how):
    """A bf16 (1, 64, 12, 64) operand the tensor-core kernels cannot read:
    its base one element past a 16-byte boundary, or a row stride that is
    not a multiple of 8 elements."""
    if how == "offset":
        buf = torch.zeros(1 + 64 * 768, device=dev, dtype=torch.bfloat16)
        return buf[1:].view(1, 64, 12, 64)
    buf = torch.zeros((1, 64, 769), device=dev, dtype=torch.bfloat16)
    return buf[..., :768].unflatten(-1, (12, 64))


@pytest.mark.parametrize("how", ["offset", "stride"])
def test_flash_tc_refuses_misaligned_operands(cuda_device, how):
    """No fallback: the wrappers raise and launch nothing, and the C entry
    points refuse the same operand before any launch."""
    bad = _misaligned(cuda_device, how)
    good = torch.zeros((1, 64, 12, 64), device=cuda_device,
                       dtype=torch.bfloat16)
    lse = torch.zeros((12, 64), device=cuda_device)
    before = (t_flash.launches, t_flash.bwd_launches, t_flash.f32_launches,
              t_flash.f32_bwd_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_flash.flash_attention(bad, good, good)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_flash.flash_attention_bwd(good, bad, good, lse, lse, good)
    assert (t_flash.launches, t_flash.bwd_launches, t_flash.f32_launches,
            t_flash.f32_bwd_launches) == before
    out = torch.empty_like(good)
    st = [x for t in (bad, good, good, out) for x in t.stride()[:3]]
    rc = _build.lib().rtt_flash_attention_fwd(
        bad.data_ptr(), good.data_ptr(), good.data_ptr(), out.data_ptr(),
        None, 1, 64, 12, 64, *st, 1, 0.18, 1, 64,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1                      # cudaErrorInvalidValue


def test_flash_f32_goes_to_the_scalar_kernels(cuda_device):
    """float32 dispatches to the scalar kernels: their counters move, the
    tensor-core kernels' do not."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn((2, 65, 12, 64), generator=g, device=cuda_device,
                    requires_grad=True)
    before = (t_flash.launches, t_flash.bwd_launches, t_flash.f32_launches,
              t_flash.f32_bwd_launches)
    t_flash.flash_attention(q, q, q, True).sum().backward()
    torch.cuda.synchronize()
    assert (t_flash.launches, t_flash.bwd_launches, t_flash.f32_launches,
            t_flash.f32_bwd_launches) == \
        (before[0], before[1], before[2] + 1, before[3] + 1)
    assert torch.isfinite(q.grad).all()
