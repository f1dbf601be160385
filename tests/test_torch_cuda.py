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


# 768: GPT-2 124M's width, the vector-I/O kernel; 1600: GPT-2 XL's,
# wider than its register tile, the wide-row kernel.
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


# (33, 1600): wider than the register tile, the wide-row kernel; 333
# rows: a ragged last stripe.
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


def _ln_wide_counts():
    return (t_ln.wide_launches, t_ln.bwd_wide_launches)


@pytest.mark.parametrize("E", [1024, 1280, 1600])
@pytest.mark.parametrize("N", [8192, 333, 1])
def test_layer_norm_wide_rows_match_plain(cuda_device, N, E):
    """GPT-2 medium, large and xl's rows (E 1024, 1280, 1600) in bf16 and
    float32: the wide-row kernels, forward (with stats) and backward,
    counted apart from the other instantiations, against the plain
    versions (bf16 within one step of each element, float32 1e-5;
    dscale/dbias as test_layer_norm_bwd_kernel_matches_plain), the sums
    bitwise equal across two calls."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn((N, E), generator=g, device=cuda_device) * 2 + 0.5
    gy = torch.randn((N, E), generator=g, device=cuda_device)
    s = 1 + 0.1 * torch.randn(E, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(E, generator=g, device=cuda_device)
    for dt in (torch.bfloat16, torch.float32):
        xd, gd = x.to(dt), gy.to(dt)
        before, wide = _ln_counts(), _ln_wide_counts()
        y, mu, rstd = t_ln.ln_fwd(xd, s, b, 1e-5, want_stats=True)
        dx, ds, db = t_ln.ln_bwd(xd, s, gd, mu, rstd)
        _, ds2, db2 = t_ln.ln_bwd(xd, s, gd, mu, rstd)
        torch.cuda.synchronize()
        assert _ln_counts() == before
        assert _ln_wide_counts() == (wide[0] + 1, wide[1] + 2)
        yp, mup, rstdp = t_ln.ln_fwd_plain(xd, s, b, 1e-5)
        dxp, dsp, dbp = t_ln.ln_bwd_plain(xd, s, gd, mu, rstd)
        if dt == torch.bfloat16:
            _within_bf16_steps(y, yp, 1)
            _within_bf16_steps(dx, dxp, 1)
        else:
            torch.testing.assert_close(y, yp, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(dx, dxp, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(mu, mup, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(rstd, rstdp, atol=0, rtol=1e-5)
        torch.testing.assert_close(ds, dsp, atol=1e-6 * N, rtol=1e-5)
        torch.testing.assert_close(db, dbp, atol=1e-6 * N, rtol=1e-5)
        assert torch.equal(ds, ds2) and torch.equal(db, db2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_layer_norm_wide_misaligned_rows_take_the_scalar_route(cuda_device,
                                                               dt):
    """E 1600 with a base one element off a 16-byte boundary: by
    launch_plan's rule the scalar-I/O kernels, counted as such, held to
    the plain versions; the C entry refuses the wide route for it,
    launching nothing."""
    N, E = 64, 1600
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.empty(1 + N * E, device=cuda_device, dtype=dt)[1:].view(N, E)
    x.copy_(torch.randn((N, E), generator=g, device=cuda_device))
    assert x.data_ptr() % 16
    gy = torch.randn((N, E), generator=g, device=cuda_device).to(dt)
    s = 1 + 0.1 * torch.randn(E, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(E, generator=g, device=cuda_device)
    before, wide = _ln_counts(), _ln_wide_counts()
    y, mu, rstd = t_ln.ln_fwd(x, s, b, 1e-5, want_stats=True)
    dx, _, _ = t_ln.ln_bwd(x, s, gy, mu, rstd)
    torch.cuda.synchronize()
    assert _ln_wide_counts() == wide
    assert _ln_counts() == (before[0], before[1] + 1, before[2],
                            before[3] + 1)
    yp, _, _ = t_ln.ln_fwd_plain(x, s, b, 1e-5)
    dxp, _, _ = t_ln.ln_bwd_plain(x, s, gy, mu, rstd)
    tol = 1e-5 if dt == torch.float32 else 2 ** -7 * 8
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=0)
    torch.testing.assert_close(dx.float(), dxp.float(), atol=tol, rtol=0)
    out = torch.empty((N, E), device=cuda_device, dtype=dt)
    rc = _build.entry("rtt_layer_norm_fwd")(
        x.data_ptr(), x.stride(0), s.data_ptr(), b.data_ptr(),
        out.data_ptr(), None, None, N, E, 1e-5,
        0 if dt == torch.float32 else 1, t_ln.ROUTES["wide"], 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1                      # cudaErrorInvalidValue


def _ln_counts():
    return (t_ln.launches, t_ln.scalar_launches, t_ln.bwd_launches,
            t_ln.bwd_scalar_launches)


def _scalar_io_input(dev, how, N=64):
    """A (N, E) float32 x the vector-I/O kernels cannot read: its base one
    element past a 16-byte boundary (E = 768), or E = 100."""
    g = torch.Generator(device=dev).manual_seed(8)
    if how == "offset":
        buf = torch.randn(1 + N * 768, generator=g, device=dev)
        return buf[1:].view(N, 768)
    return torch.randn((N, 100), generator=g, device=dev)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["offset", "e100"])
def test_layer_norm_scalar_io_instantiation(cuda_device, how, dt):
    """A layout the vector kernels do not take goes to the scalar-I/O
    kernels, forward and backward, counted apart and held to the plain
    versions; the C entry refuses it for the vector kernel, launching
    nothing."""
    x = _scalar_io_input(cuda_device, how)
    if dt == torch.bfloat16:
        # cast in place of the view, keeping it one element off alignment
        x = x.to(dt) if how == "e100" else \
            torch.empty(1 + x.numel(), device=cuda_device, dtype=dt)[1:] \
            .view(x.shape).copy_(x)
    N, E = x.shape
    assert how == "e100" or x.data_ptr() % 16
    s = 1 + 0.1 * torch.randn(E, device=cuda_device)
    b = 0.1 * torch.randn(E, device=cuda_device)
    gy = torch.randn((N, E), device=cuda_device).to(dt)
    tol = 1e-5 if dt == torch.float32 else 2 ** -7 * 8
    before = _ln_counts()
    y, mu, rstd = t_ln.ln_fwd(x, s, b, 1e-5, want_stats=True)
    dx, ds, db = t_ln.ln_bwd(x, s, gy, mu, rstd)
    torch.cuda.synchronize()
    assert _ln_counts() == (before[0], before[1] + 1, before[2],
                            before[3] + 1)
    yp, mup, rstdp = t_ln.ln_fwd_plain(x, s, b, 1e-5)
    dxp, dsp, dbp = t_ln.ln_bwd_plain(x, s, gy, mu, rstd)
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mu, mup, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dx.float(), dxp.float(), atol=tol, rtol=0)
    torch.testing.assert_close(ds, dsp, atol=1e-6 * N, rtol=1e-5)
    torch.testing.assert_close(db, dbp, atol=1e-6 * N, rtol=1e-5)
    out = torch.empty((N, E), device=cuda_device, dtype=dt)
    rc = _build.entry("rtt_layer_norm_fwd")(
        x.data_ptr(), x.stride(0), s.data_ptr(), b.data_ptr(),
        out.data_ptr(), None, None, N, E, 1e-5,
        0 if dt == torch.float32 else 1, 1, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1                      # cudaErrorInvalidValue


def test_layer_norm_fwd_train_shape_with_stats(cuda_device):
    """The train step's rows, (32768, 768) bf16 with mu/rstd: the vector
    kernel walks several rows a warp here, through its register ring."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn((32768, 768), generator=g, device=cuda_device)
    x = x.to(torch.bfloat16)
    s = 1 + 0.1 * torch.randn(768, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(768, generator=g, device=cuda_device)
    before = _ln_counts()
    y, mu, rstd = t_ln.ln_fwd(x, s, b, 1e-5, want_stats=True)
    torch.cuda.synchronize()
    assert _ln_counts() == (before[0] + 1,) + before[1:]
    yp, mup, rstdp = t_ln.ln_fwd_plain(x, s, b, 1e-5)
    _within_bf16_steps(y, yp, 1)
    torch.testing.assert_close(mu, mup, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstdp, atol=0, rtol=1e-5)


@pytest.mark.parametrize("N", [32768, 333])
def test_layer_norm_bwd_sums_bitwise_repeatable(cuda_device, N):
    """dscale and dbias are summed in a fixed order: two calls on the
    same inputs agree to the bit."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn((N, 768), generator=g, device=cuda_device)
    x = x.to(torch.bfloat16)
    gy = torch.randn((N, 768), generator=g, device=cuda_device)
    gy = gy.to(torch.bfloat16)
    s = 1 + 0.1 * torch.randn(768, generator=g, device=cuda_device)
    _, mu, rstd = t_ln.ln_fwd_plain(x, s, torch.zeros_like(s))
    before = _ln_counts()
    dx1, ds1, db1 = t_ln.ln_bwd(x, s, gy, mu, rstd)
    dx2, ds2, db2 = t_ln.ln_bwd(x, s, gy, mu, rstd)
    torch.cuda.synchronize()
    assert _ln_counts() == before[:2] + (before[2] + 2, before[3])
    assert torch.equal(dx1, dx2)
    assert torch.equal(ds1, ds2) and torch.equal(db1, db2)


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
    assert "ray_tpu_torch_flash_fwd" in o.grad_fn.name()
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


@pytest.mark.parametrize("block_m", t_flash.BLOCK_MS[64])
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
        None, 1, 64, 12, 12, 64, *st, 1, 0.18, 1, 64,
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


def _llama_qkv(dev, B, T, seed):
    """Llama-3 8B's attention operands: q a view of a (B, T, 4096)
    projection as 32 heads of 128, k and v (B, T, 8, 128) of their own."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, 4096), generator=g, device=dev)
    k, v = (torch.randn((B, T, 8, 128), generator=g, device=dev)
            for _ in range(2))
    return (q.to(torch.bfloat16).view(B, T, 32, 128), k.to(torch.bfloat16),
            v.to(torch.bfloat16))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [64, 333, 1024])
def test_flash_gqa_d128_forward_matches_plain(cuda_device, T, B):
    """The head-dim-128 instantiation reading 8 KV heads under 32 query
    heads, against the plain version (which expands the groups), within
    one bf16 step; counted apart from the head-dim-64 kernel."""
    q, k, v = _llama_qkv(cuda_device, B, T, 11)
    for causal in (True, False):
        before = (t_flash.launches, t_flash.d128_launches,
                  t_flash.f32_launches)
        out, lse = t_flash.flash_attention(q, k, v, causal, want_lse=True)
        ref, rlse = t_flash.flash_attention_plain(q, k, v, causal, True)
        torch.cuda.synchronize()
        assert (t_flash.launches, t_flash.d128_launches,
                t_flash.f32_launches) == (before[0], before[1] + 1,
                                          before[2])
        assert out.shape == (B, T, 32, 128) and lse.shape == (B * 32, T)
        _within_bf16_steps(out, ref, 1)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("how", ["offset", "stride"])
def test_flash_gqa_d128_refuses_misaligned_operands(cuda_device, how):
    """At head dim 128 too: the wrapper raises and launches nothing, and
    the C entry refuses the operand (and H % KV != 0) before any launch."""
    if how == "offset":
        buf = torch.zeros(1 + 64 * 1024, device=cuda_device,
                          dtype=torch.bfloat16)
        bad = buf[1:].view(1, 64, 8, 128)
    else:
        buf = torch.zeros((1, 64, 1025), device=cuda_device,
                          dtype=torch.bfloat16)
        bad = buf[..., :1024].unflatten(-1, (8, 128))
    q = torch.zeros((1, 64, 32, 128), device=cuda_device,
                    dtype=torch.bfloat16)
    good = torch.zeros((1, 64, 8, 128), device=cuda_device,
                       dtype=torch.bfloat16)
    before = (t_flash.launches, t_flash.d128_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_flash.flash_attention(q, bad, good)
    assert (t_flash.launches, t_flash.d128_launches) == before
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for kk, kv in ((bad, 8), (good, 6)):
        st = [x for t in (q, kk, good, out) for x in t.stride()[:3]]
        rc = _build.lib().rtt_flash_attention_fwd(
            q.data_ptr(), kk.data_ptr(), good.data_ptr(), out.data_ptr(),
            None, 1, 64, 32, kv, 128, *st, 1, 0.13, 1, 64, stream)
        assert rc == 1                  # cudaErrorInvalidValue


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [64, 333, 2048])
def test_flash_gqa_d128_backward_matches_plain(cuda_device, T, B):
    """The head-dim-128 grouped backward (32 query heads over 8 KV heads)
    against the plain version, which sums dk and dv over each group in
    float32 at the kernel's point, within two bf16 steps (the head-dim-64
    backward's limit); dk and dv keep the KV heads; counted apart from
    the head-dim-64 kernel."""
    q, k, v = _llama_qkv(cuda_device, B, T, 12)
    g = torch.Generator(device=cuda_device).manual_seed(13)
    do = torch.randn((B, T, 32, 128), generator=g, device=cuda_device)
    do = do.to(torch.bfloat16)
    for causal in (True, False):
        out, lse = t_flash.flash_attention_plain(q, k, v, causal, True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .reshape(B * 32, T)
        before = (t_flash.bwd_launches, t_flash.d128_bwd_launches,
                  t_flash.f32_bwd_launches)
        got = t_flash.flash_attention_bwd(q, k, v, lse, delta, do, causal)
        ref = t_flash.flash_attention_bwd_plain(q, k, v, lse, delta, do,
                                                causal)
        torch.cuda.synchronize()
        assert (t_flash.bwd_launches, t_flash.d128_bwd_launches,
                t_flash.f32_bwd_launches) == (before[0], before[1] + 1,
                                              before[2])
        assert got[0].shape == q.shape
        assert got[1].shape == k.shape and got[2].shape == v.shape
        for a, r in zip(got, ref):
            assert a.dtype == torch.bfloat16 and a.is_contiguous()
            _within_bf16_steps(a, r, 2)


def test_flash_gqa_d128_autograd_launches_both_kernels(cuda_device):
    """Under autograd the grouped head-dim-128 attention runs the forward
    kernel with the lse and the backward kernel, and the grads of k and v
    come back with the KV heads."""
    q, k, v = (t.detach().requires_grad_()
               for t in _llama_qkv(cuda_device, 2, 128, 14))
    before = (t_flash.d128_launches, t_flash.d128_bwd_launches,
              t_flash.launches, t_flash.bwd_launches)
    t_flash.flash_attention(q, k, v, True).float().sum().backward()
    torch.cuda.synchronize()
    assert (t_flash.d128_launches, t_flash.d128_bwd_launches,
            t_flash.launches, t_flash.bwd_launches) == \
        (before[0] + 1, before[1] + 1, before[2], before[3])
    assert k.grad.shape == (2, 128, 8, 128) and v.grad.shape == k.grad.shape
    for t in (q, k, v):
        assert torch.isfinite(t.grad.float()).all() and t.grad.abs().sum() > 0


@pytest.mark.parametrize("how", ["offset", "stride", "kv_heads"])
def test_flash_gqa_d128_backward_refuses(cuda_device, how):
    """The wrapper raises and launches nothing, and the C entry refuses
    before any launch: a misaligned operand, H % KV != 0; and head dim
    64 with KV groups (the head-dim-64 backward takes KV = H only)."""
    q = torch.zeros((1, 64, 32, 128), device=cuda_device,
                    dtype=torch.bfloat16)
    good = torch.zeros((1, 64, 8, 128), device=cuda_device,
                       dtype=torch.bfloat16)
    kv = 8
    if how == "offset":
        buf = torch.zeros(1 + 64 * 1024, device=cuda_device,
                          dtype=torch.bfloat16)
        bad = buf[1:].view(1, 64, 8, 128)
    elif how == "stride":
        buf = torch.zeros((1, 64, 1025), device=cuda_device,
                          dtype=torch.bfloat16)
        bad = buf[..., :1024].unflatten(-1, (8, 128))
    else:
        bad, kv = good, 6
    lse = torch.zeros((32, 64), device=cuda_device)
    before = (t_flash.bwd_launches, t_flash.d128_bwd_launches)
    if how != "kv_heads":
        with pytest.raises(ValueError, match="16-byte aligned"):
            t_flash.flash_attention_bwd(q, bad, good, lse, lse, q)
    q64 = torch.zeros((1, 64, 4, 64), device=cuda_device,
                      dtype=torch.bfloat16)
    kv64 = torch.zeros((1, 64, 2, 64), device=cuda_device,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 flash backward"):
        t_flash.flash_attention_bwd(q64, kv64, kv64, lse[:4], lse[:4], q64)
    assert (t_flash.bwd_launches, t_flash.d128_bwd_launches) == before
    out = torch.empty_like(q)
    dkv = torch.empty_like(good)
    st = [x for t in (q, bad, good, q) for x in t.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    rc = _build.lib().rtt_flash_attention_bwd(
        q.data_ptr(), bad.data_ptr(), good.data_ptr(), q.data_ptr(),
        lse.data_ptr(), lse.data_ptr(), out.data_ptr(), dkv.data_ptr(),
        dkv.data_ptr(), 1, 64, 32, kv, 128, *st, 1, 0.13, 0.088, 1, stream)
    assert rc == 1                      # cudaErrorInvalidValue
    st64 = [x for t in (q64, kv64, kv64, q64) for x in t.stride()[:3]]
    rc = _build.lib().rtt_flash_attention_bwd(
        q64.data_ptr(), kv64.data_ptr(), kv64.data_ptr(), q64.data_ptr(),
        lse.data_ptr(), lse.data_ptr(), out.data_ptr(), dkv.data_ptr(),
        dkv.data_ptr(), 1, 64, 4, 2, 64, *st64, 1, 0.18, 0.125, 1, stream)
    assert rc == 1
    torch.cuda.synchronize()


# The encoder and vision paths: BERT-base serving's rows (eps 1e-12,
# batch 8 x 128) and ViT-B/16 training's (eps 1e-6, 128 x 197 rows).
@pytest.mark.parametrize("N", [1024, 25216])
@pytest.mark.parametrize("eps", [1e-12, 1e-6])
def test_layer_norm_kernels_at_the_encoder_eps(cuda_device, N, eps):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((N, 768), generator=g, device=cuda_device).bfloat16()
    gy = torch.randn((N, 768), generator=g, device=cuda_device).bfloat16()
    s = 1 + 0.1 * torch.randn(768, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(768, generator=g, device=cuda_device)
    before = (t_ln.launches, t_ln.bwd_launches)
    y, mu, rstd = t_ln.ln_fwd(x, s, b, eps, want_stats=True)
    yp, mup, rstdp = t_ln.ln_fwd_plain(x, s, b, eps)
    _within_bf16_steps(y, yp, 1)
    torch.testing.assert_close(mu, mup, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstdp, atol=0, rtol=1e-5)
    dx, ds, db = t_ln.ln_bwd(x, s, gy, mu, rstd)
    dxp, dsp, dbp = t_ln.ln_bwd_plain(x, s, gy, mup, rstdp)
    _within_bf16_steps(dx, dxp, 1)
    torch.testing.assert_close(ds, dsp, atol=1e-6 * N, rtol=1e-5)
    torch.testing.assert_close(db, dbp, atol=1e-6 * N, rtol=1e-5)
    assert (t_ln.launches, t_ln.bwd_launches) == \
        (before[0] + 1, before[1] + 1)              # the vector route


def test_layer_norm_reads_vit_cls_rows_in_place(cuda_device):
    """ViT's ln_f runs on x[:, 0] of (128, 197, 768): 128 rows 197 x 768
    elements apart, read in place on the vector route, forward and
    backward through the autograd Function."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    h = torch.randn((128, 197, 768), generator=g,
                    device=cuda_device).bfloat16().requires_grad_(True)
    s = (1 + 0.1 * torch.randn(768, generator=g, device=cuda_device)) \
        .requires_grad_(True)
    b = torch.zeros(768, device=cuda_device, requires_grad=True)
    cls = h[:, 0]
    assert cls.stride() == (197 * 768, 1)
    before = {a: getattr(t_ln, a) for a in (
        "launches", "bwd_launches", "scalar_launches",
        "bwd_scalar_launches")}
    y = t_ln.layer_norm(cls, s, b, 1e-6)
    gy = torch.randn(y.shape, generator=g, device=cuda_device).bfloat16()
    got = torch.autograd.grad(y, (h, s, b), gy)
    yp = t_ln.layer_norm_plain(cls, s, b, 1e-6)
    ref = torch.autograd.grad(yp, (h, s, b), gy)
    _within_bf16_steps(y, yp, 1)
    _within_bf16_steps(got[0][:, 0], ref[0][:, 0], 1)
    assert not got[0][:, 1:].any()
    torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got[2], ref[2], atol=1e-4, rtol=1e-4)
    assert {a: getattr(t_ln, a) - n for a, n in before.items()} == {
        "launches": 1, "bwd_launches": 1, "scalar_launches": 0,
        "bwd_scalar_launches": 0}


@pytest.mark.parametrize("buckets,max_dist", [(32, 128), (8, 32)])
def test_t5_bucket_tables_on_cuda_equal_the_cpus(cuda_device, buckets,
                                                 max_dist):
    """T5's buckets come from a float32 log truncated to int32: the
    card's table equals the CPU's at every relative position in [-4096,
    4096], both directions."""
    from ray_tpu_torch.models import t5
    rel = torch.arange(-4096, 4097, dtype=torch.int32)
    for bidirectional in (True, False):
        ref = t5._relative_buckets(rel, buckets, max_dist, bidirectional)
        got = t5._relative_buckets(rel.to(cuda_device), buckets, max_dist,
                                   bidirectional)
        assert torch.equal(got.cpu(), ref)
