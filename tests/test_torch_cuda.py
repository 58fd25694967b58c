"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc; skips with the reason elsewhere.  The file
imports only torch and the port (not JAX), so on the GPU machine it runs
without the repository's JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import collections

import pytest
import torch
import torch.distributed as dist

from video_learning_tpu_torch.ops import lrn as lrn_mod
from video_learning_tpu_torch.ops import lstm_step as lstm_mod
from video_learning_tpu_torch.parallel.mesh import Mesh


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs the same checks on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


# (channels, radius): the AlexNet conv1 / conv2 sites, a ragged channel
# count, and a radius the kernel does not unroll
@pytest.mark.cuda
@pytest.mark.parametrize("channels,radius", [(96, 2), (256, 2), (7, 2),
                                             (40, 3)])
def test_lrn_kernel_matches_plain(gen, channels, radius):
    x = torch.relu(torch.randn((4, 9, 9, channels), generator=gen,
                               device="cuda") * 40)
    before = lrn_mod.lrn.launches
    torch.testing.assert_close(lrn_mod.lrn(x, radius),
                               lrn_mod.lrn_reference(x, radius),
                               rtol=1e-5, atol=1e-6)
    xb = x.to(torch.bfloat16)
    # bf16 out: within one bf16 ulp of the plain version
    torch.testing.assert_close(lrn_mod.lrn(xb, radius).float(),
                               lrn_mod.lrn_reference(xb, radius).float(),
                               rtol=1e-2, atol=1e-6)
    assert lrn_mod.lrn.launches == before + 2


# the AlexNet training sites' channel counts, rows of 12 bf16 chunks that
# cross warps (96) and of whole warps (256)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [96, 256])
def test_lrn_vector_kernel_equals_the_staged_one(gen, channels, dtype):
    """The forward's vector design on aligned tensors and its staged
    design on a view that starts 2 bytes into its storage (which the
    vector design cannot read in 16-byte chunks): the same arithmetic in
    the same order, so the same bits."""
    shape = (3, 7, 5, channels)
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda") * 40) \
        .to(dtype)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    xu = buf[1:].view(shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    by_variant = dict(lrn_mod.lrn.variant_launches)
    vector = lrn_mod.lrn(x)
    staged = lrn_mod.lrn(xu)
    by_variant["vector"] += 1
    by_variant["staged"] += 1
    assert lrn_mod.lrn.variant_launches == by_variant
    assert torch.equal(vector, staged)
    if dtype == torch.float32:
        torch.testing.assert_close(vector, lrn_mod.lrn_reference(x),
                                   rtol=1e-5, atol=1e-6)
    # the moderate-denominator fast path and the IEEE calls (a huge x, a
    # beta other than 0.75) give the staged design's bits too
    x[0, 0] = 1e9
    xu.copy_(x)
    for kw in (dict(), dict(beta=0.6)):
        assert torch.equal(lrn_mod.lrn(x, **kw), lrn_mod.lrn(xu, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5, 128])
def test_lstm_step_kernel_matches_plain(gen, batch):
    args = [torch.randn(s, generator=gen, device="cuda") * 0.1
            for s in ((batch, 1024), (batch, 256), (batch, 256),
                      (256, 1024), (1024,))]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # a float32 reference
    try:
        want = lstm_mod.lstm_step_reference(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for got, ref in zip(lstm_mod.lstm_step(*args), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(gen):
    from video_learning_tpu_torch.utils import FrameworkError
    with pytest.raises(FrameworkError):
        lrn_mod.lrn(torch.zeros((2, 3, 3, 8), dtype=torch.float16,
                                device="cuda"))
    with pytest.raises(FrameworkError):
        lrn_mod.lrn(torch.zeros((2, 8, 3, 3), device="cuda")
                    .permute(0, 2, 3, 1))          # not contiguous
    args = [torch.zeros(s, device="cuda")
            for s in ((2, 64), (2, 16), (2, 16), (16, 64), (64,))]
    args[0] = args[0].double()
    with pytest.raises(FrameworkError):
        lstm_mod.lstm_step(*args)


def _vector_takes(channels, radius, dtype):
    """Whether csrc/lrn_bwd.cu's vector design takes the shape (for
    aligned tensors): 16-byte channel chunks, radius <= half a chunk."""
    chunk = 16 // torch.tensor([], dtype=dtype).element_size()
    return channels % chunk == 0 and 2 * radius <= chunk


# the two AlexNet training sites (conv1, conv2), a ragged channel count, a
# radius the vector design takes only in bf16, rows of one and of two
# chunks, a row count no tile divides with rows of 12 bf16 chunks that
# cross warps, and rows of exactly one warp's chunks
@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius", [
    ((4, 9, 9, 96), 2), ((4, 9, 9, 256), 2), ((4, 9, 9, 7), 2),
    ((4, 9, 9, 40), 3), ((4, 9, 9, 8), 2), ((4, 9, 9, 16), 2),
    ((3, 7, 5, 96), 2), ((2, 9, 9, 256), 2)])
def test_lrn_backward_kernel_matches_plain(gen, shape, radius):
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda") * 40)
    g = torch.randn(shape, generator=gen, device="cuda")
    before = lrn_mod.lrn_backward.launches
    by_variant = dict(lrn_mod.lrn_backward.variant_launches)
    out = lrn_mod.lrn_backward(x, g, radius)
    ref = lrn_mod.lrn_backward_reference(x, g, radius)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # the same formula, the sums in the same order: the same bits
    assert torch.equal(out, ref)
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    outb = lrn_mod.lrn_backward(xb, gb, radius)
    # bf16 dx: within one bf16 ulp of the plain version
    torch.testing.assert_close(
        outb.float(), lrn_mod.lrn_backward_reference(xb, gb, radius).float(),
        rtol=1e-2, atol=1e-2 * float(g.abs().max()))
    assert lrn_mod.lrn_backward.launches == before + 2
    for dtype in (torch.float32, torch.bfloat16):
        name = "vector" if _vector_takes(shape[-1], radius, dtype) \
            else "staged"
        by_variant[name] += 1
    assert lrn_mod.lrn_backward.variant_launches == by_variant
    # no atomics, no order that depends on scheduling: the same bits twice
    assert torch.equal(lrn_mod.lrn_backward(xb, gb, radius), outb)
    assert torch.equal(lrn_mod.lrn_backward(x, g, radius), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_backward_kernel_outside_its_fast_range(gen, dtype):
    """Denominators outside [2^-32, 2^32] (a huge x; a tiny bias and
    alpha) and a beta other than 0.75 send the vector kernel's tiles
    through rsqrtf, sqrtf and __fdiv_rn themselves: still within the
    plain version's tolerances, and its bits where beta is 0.75."""
    shape = (3, 7, 5, 96)
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda") * 40)
    x[0, 0] *= 1e9
    x = x.to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    vector = lrn_mod.lrn_backward.variant_launches["vector"]
    for kw in (dict(), dict(bias=1e-12, alpha=1e-12), dict(beta=0.6)):
        out = lrn_mod.lrn_backward(x, g, 2, **kw)
        ref = lrn_mod.lrn_backward_reference(x, g, 2, **kw)
        assert bool(torch.isfinite(ref).all())
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(
                out.float(), ref.float(), rtol=1e-2,
                atol=1e-2 * float(ref.float().abs().max()))
        if "beta" not in kw:
            assert torch.equal(out, ref)
    assert lrn_mod.lrn_backward.variant_launches["vector"] == vector + 3


@pytest.mark.cuda
def test_lrn_backward_unaligned_tensors_take_the_staged_kernel(gen):
    """A view that starts 2 bytes into its storage cannot be read in
    16-byte chunks: the staged design takes it, with the same result."""
    shape = (2, 5, 5, 96)
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda") * 40)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    xu = buf[1:].view(shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    staged = lrn_mod.lrn_backward.variant_launches["staged"]
    out = lrn_mod.lrn_backward(xu, g)
    assert lrn_mod.lrn_backward.variant_launches["staged"] == staged + 1
    assert torch.equal(out, lrn_mod.lrn_backward(xu.clone(), g))


# (39, 43) and (45, 37) as in the CPU tests; (40, 42) pads asymmetrically;
# (20, 21) has fewer gradient rows per image (5) than a bf16 tile holds;
# (227, 227) is the training geometry
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 39, 43, 3), (2, 45, 37, 3),
                                   (5, 40, 42, 3), (6, 20, 21, 3),
                                   (2, 227, 227, 3)])
def test_conv1_dw_kernels_match_plain(gen, shape, dtype):
    from video_learning_tpu_torch.ops import conv1_dw as c1
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # a float32 reference
    try:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        gout = torch.randn((shape[0], -(-shape[1] // 4), -(-shape[2] // 4),
                            96), generator=gen, device="cuda").to(dtype)
        ref = c1.conv1_dw_reference(x, gout)
        before = (c1.conv1_dw.launches, c1.conv1_dw_shifted.launches)
        # float32 sums in another order; bf16 products are exact in f32
        tol = dict(rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
        # row ranges that cross images, and ones that start inside an
        # image and hold less than a tile
        for out in (c1.conv1_dw(x, gout), c1.conv1_dw(x, gout,
                                                       block_images=1),
                    c1.conv1_dw_shifted(x, gout),
                    c1.conv1_dw_shifted(x, gout, block_rows=7),
                    c1.conv1_dw_shifted(x, gout, block_rows=3)):
            assert out.dtype == torch.float32 and out.shape == ref.shape
            torch.testing.assert_close(out, ref, **tol)
        assert (c1.conv1_dw.launches, c1.conv1_dw_shifted.launches) == \
            (before[0] + 2, before[1] + 3)
        # fixed-order reduction, no atomics: the same bits every run
        assert torch.equal(c1.conv1_dw_shifted(x, gout),
                           c1.conv1_dw_shifted(x, gout))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_bare_wrappers_refuse_tensors_that_need_a_gradient(gen):
    """A kernel's output has no grad_fn: the bare wrappers raise instead
    of handing back a detached result, and the autograd Functions carry
    the gradient."""
    from video_learning_tpu_torch.ops.lstm_step import LSTMStepFunction
    from video_learning_tpu_torch.utils import FrameworkError
    x = torch.rand((2, 3, 3, 8), generator=gen,
                   device="cuda").requires_grad_(True)
    with pytest.raises(FrameworkError, match="LRNFunction"):
        lrn_mod.lrn(x)
    with torch.no_grad():
        lrn_mod.lrn(x)
    lrn_mod.LRNFunction.apply(x, 2, 1.0, 2e-5, 0.75).sum().backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    args = [torch.randn(s, generator=gen, device="cuda").requires_grad_(True)
            for s in ((2, 64), (2, 16), (2, 16), (16, 64), (64,))]
    with pytest.raises(FrameworkError, match="LSTMStepFunction"):
        lstm_mod.lstm_step(*args)
    h, c = LSTMStepFunction.apply(*args)
    (h.sum() + c.sum()).backward()
    assert all(a.grad is not None for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 256])
def test_lstm_step_kernel_matches_plain_at_decode_shapes(gen, batch):
    """The caption decode's shapes: H = 512 at 64 rows (greedy) and 256
    rows (beam-4)."""
    H = 512
    args = [torch.randn(s, generator=gen, device="cuda") * 0.1
            for s in ((batch, 4 * H), (batch, H), (batch, H), (H, 4 * H),
                      (4 * H,))]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # a float32 reference
    try:
        want = lstm_mod.lstm_step_reference(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    before = lstm_mod.lstm_step.launches
    for got, ref in zip(lstm_mod.lstm_step(*args), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert lstm_mod.lstm_step.launches == before + 1


def _lstm_args(gen, batch, hidden, offset=0):
    """Phase 2's inputs; ``offset`` floats into each buffer (a view that
    is not 16-byte aligned: the kernel's cp.async copies, not TMA)."""
    shapes = ((batch, 4 * hidden), (batch, hidden), (batch, hidden),
              (hidden, 4 * hidden), (4 * hidden,))
    scales = (1.0, 1.0, 1.0, 0.05, 0.1)
    out = []
    for shape, scale in zip(shapes, scales):
        n = int(torch.tensor(shape).prod())
        t = torch.empty(n + offset, device="cuda")[offset:].view(shape)
        t.copy_(torch.randn(shape, generator=gen, device="cuda") * scale)
        out.append(t)
    out[1] = torch.tanh(out[1])
    return out


# H not a multiple of the j tile; H not a multiple of 4 (no TMA); one row
# past two 128-row groups; pointers 4 bytes past 16-byte alignment
@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden,offset", [(3, 40, 0), (2, 37, 0),
                                                 (257, 512, 0), (5, 256, 1)])
def test_lstm_step_kernel_matches_plain_at_ragged_shapes(gen, batch, hidden,
                                                         offset):
    args = _lstm_args(gen, batch, hidden, offset)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # a float32 reference
    try:
        want = lstm_mod.lstm_step_reference(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for got, ref in zip(lstm_mod.lstm_step(*args), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


# the main path's shapes: the cluster's sums meet in a fixed order
@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(32, 256), (128, 256), (64, 512),
                                          (256, 512)])
def test_lstm_step_kernel_gives_the_same_bits_twice(gen, batch, hidden):
    args = _lstm_args(gen, batch, hidden)
    first = lstm_mod.lstm_step(*args)
    second = lstm_mod.lstm_step(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _decoder(seed=0, H=512, E=300, V=1000, items=2):
    """A 1x512 caption decoder (lstm params, output FC, embeddings,
    state-bias visual) on the CPU, drawn from a torch seed."""
    from video_learning_tpu_torch.models import layers
    from video_learning_tpu_torch.models import lstm
    g = torch.Generator().manual_seed(seed)
    return (lstm.init(g, E, H, 1), layers.fc_init(g, H, V),
            torch.randn((V, E), generator=g),
            torch.tanh(torch.randn((items, H), generator=g)))


def _on(tree, device, requires_grad=False):
    if isinstance(tree, dict):
        return {k: _on(v, device, requires_grad) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device, requires_grad) for v in tree]
    return tree.to(device).requires_grad_(requires_grad)


def _first_difference(a, b):
    for i, (ra, rb) in enumerate(zip(a, b)):
        diff = (ra != rb).nonzero()
        if len(diff):
            return i, int(diff[0])
    return None


@pytest.mark.cuda
def test_greedy_decode_on_the_card_matches_the_cpu(gen):
    """float32, TF32 off: tokens equal, except from a step whose CPU top-2
    logit margin is below 1e-4 x max(1, max|logit|); logits up to that
    step within 1e-3 x max(1, max|logit|).  The decode runs on live
    parameters that require gradients (it runs under no_grad) and launches
    one lstm_step kernel per step."""
    from video_learning_tpu_torch.defs import defs
    from video_learning_tpu_torch.models import lstm
    params, out_fc, emb, visual = _decoder()
    T, out = 20, {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cuda", "cpu"):
            before = lstm_mod.lstm_step.launches
            ids, logits = lstm.greedy_decode(
                _on(params, device, True), _on(out_fc, device, True),
                visual.to(device), emb.to(device), 999, T, 512,
                defs.rnn_visual_mode.state_bias,
                return_type=defs.return_type.standard)
            assert not logits.requires_grad
            out[device] = (ids.cpu(), logits.cpu())
            launched = lstm_mod.lstm_step.launches - before
            assert launched == (T if device == "cuda" else 0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (ids_g, log_g), (ids_c, log_c) = out["cuda"], out["cpu"]
    diff = _first_difference(ids_g, ids_c)
    upto = T if diff is None else diff[1] + 1
    scale = max(1.0, float(log_c.abs().max()))
    torch.testing.assert_close(log_g[:, :upto], log_c[:, :upto], rtol=0,
                               atol=1e-3 * scale)
    if diff is not None:
        top2 = log_c[diff[0], diff[1]].topk(2).values
        assert float(top2[0] - top2[1]) < 1e-4 * scale


@pytest.mark.cuda
def test_beam_decode_on_the_card_matches_the_cpu(gen):
    """Beam-4 in float32: tokens equal, except where the CPU's least gap
    among its K + 1 best candidate scores, at a step up to the first
    differing token, is below 1e-4 of max(1, |score|)."""
    from video_learning_tpu_torch.defs import defs
    from video_learning_tpu_torch.models import lstm
    params, out_fc, emb, visual = _decoder(seed=1)
    T, K, out, gaps = 20, 4, {}, []
    top_k = lstm._top_k

    def recording(x, k):
        vals = torch.sort(x, dim=1, descending=True).values[:, :k + 1]
        scale = vals.abs().max(dim=1).values.clamp(min=1.0)
        gaps.append(((vals[:, :-1] - vals[:, 1:]).min(dim=1).values
                     / scale).cpu())
        return top_k(x, k)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cuda", "cpu"):
            gaps.clear()
            lstm._top_k = recording
            try:
                out[device] = lstm.beam_decode(
                    _on(params, device), _on(out_fc, device),
                    visual.to(device), emb.to(device), 999, 998, T, 512,
                    defs.rnn_visual_mode.state_bias, beam_width=K).cpu()
            finally:
                lstm._top_k = top_k
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    diff = _first_difference(out["cuda"], out["cpu"])
    if diff is not None:
        i, t = diff
        assert float(torch.stack(gaps, dim=1)[i, :t + 1].min()) < 1e-4


# the int8 GEMM at shapes the serving path gives it that torch._int_mm
# takes only padded: fc6 of one 16-frame clip (16 rows), a one-item
# caption encode (1 row), a 101-class head (N 101), a K and an N that are
# not multiples of 8, and conv2's group GEMM of one clip
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16, 9216, 4096), (1, 4096, 4096),
                                   (16, 4096, 101), (5, 20, 10),
                                   (11664, 1200, 128)])
def test_int8_mm_matches_plain_with_padding(gen, m, k, n):
    from video_learning_tpu_torch.ops import int8_mm as int8_mod
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    a[0], b[:, 0] = 127, 127
    before = int8_mod.int8_mm.launches
    out = int8_mod.int8_mm(a, b)
    torch.cuda.synchronize()
    assert int8_mod.int8_mm.launches == before + 1
    assert out.dtype == torch.int32 and tuple(out.shape) == (m, n)
    assert int(out[0, 0]) == k * 127 * 127
    assert torch.equal(out, int8_mod.int8_mm_reference(a, b))


@pytest.mark.cuda
def test_int8_mm_launches_the_gemm_or_raises(gen, monkeypatch):
    """On CUDA operands the wrapper never reaches the plain version, and
    what the GEMM does not take raises: no float product, no CPU."""
    from video_learning_tpu_torch.ops import int8_mm as int8_mod
    from video_learning_tpu_torch.utils import FrameworkError

    def forbidden(*args):
        raise AssertionError("plain version reached from CUDA operands")

    monkeypatch.setattr(int8_mod, "int8_mm_reference", forbidden)
    a = torch.randint(-127, 128, (64, 64), generator=gen, device="cuda",
                      dtype=torch.int8)
    assert int8_mod.int8_mm(a, a).shape == (64, 64)
    for bad in ((a.float(), a.float()), (a, a.cpu()), (a.t(), a),
                (a, a[:, :32].t())):
        with pytest.raises(FrameworkError):
            int8_mod.int8_mm(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("groups,stride", [(1, 1), (2, 1), (1, 4)])
def test_int8_conv_on_the_card_matches_the_cpu(gen, groups, stride):
    """conv_apply_int8 on the card (int8 im2col, the int8 GEMM per group)
    against the same call on the CPU: the int32 sums are exact."""
    from video_learning_tpu_torch.models import layers
    k = 11 if stride == 4 else 5
    x = torch.randn((3, 27, 25, 96), generator=gen, device="cuda") * 3
    w = layers.hwio_to_oihw(torch.randn((k, k, 96 // groups, 64),
                                        generator=gen, device="cuda"))
    b = torch.randn((64,), generator=gen, device="cuda")
    args = ((stride, stride), "SAME")
    out = layers.conv_apply_int8({"w": w, "b": b}, x, *args, groups=groups,
                                 out_dtype=torch.float32)
    ref = layers.conv_apply_int8({"w": w.cpu(), "b": b.cpu()}, x.cpu(),
                                 *args, groups=groups,
                                 out_dtype=torch.float32)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.cuda
def test_fed_feeds_from_the_pinned_ring_equal_the_records(gen, tmp_path):
    """Twelve 1-clip batches (three times round the read-buffer ring)
    through FeedPrefetcher and Train.prepare_device_feed onto the card:
    the ring's slots are pinned, and every prepared feed, kept until the
    epoch ends, equals the batch a second feeder reads on the host (a
    slot rewritten under a copy would not)."""
    import json

    import numpy as np

    from video_learning_tpu_torch.config import Settings
    from video_learning_tpu_torch.data import records
    from video_learning_tpu_torch.data.prefetch import FeedPrefetcher
    from video_learning_tpu_torch.models.pipeline import Model
    from video_learning_tpu_torch.train import Train

    rs = np.random.RandomState(0)
    base = str(tmp_path / "videos.train")
    with records.RecordWriter(base + ".tfrecord") as w:
        for v in range(12):
            for _ in range(4):
                w.write(records.encode_image_example(
                    rs.randint(0, 256, (72, 80, 3), np.uint8), v % 3))
    records.write_size_file(12, [1] * 12, base + ".tfrecord", "video", 1, 4)
    with open(base, "w") as f:
        f.write("".join("v%d %d\n" % (v, v % 3) for v in range(12)))
    run = {"run_folder": str(tmp_path / "run"), "phase": "defs.phase.train",
           "compute_dtype": "float32",
           "data": {"d": {"data_path": base, "raw_image_shape": "(72, 80, 3)",
                          "image_shape": "(67, 67, 3)",
                          "mean_image": [104.0, 117.0, 123.0],
                          "data_format": "defs.data_format.tfrecord",
                          "imgproc": ["defs.imgproc.rand_crop",
                                      "defs.imgproc.sub_mean"],
                          "phase": "defs.phase.train",
                          "tag": "defs.dataset_tag.main",
                          "device_preprocess": True, "epoch_shuffle": True}},
           "network": {"num_classes": 3, "pipelines": [
               {"frames": {"input": "defs.dataset_tag.main",
                           "representation": "defs.representation.dcnn",
                           "frame_encoding_layer": "fc7"}},
               {"clf": {"input": "frames",
                        "representation": "defs.representation.nop",
                        "classifier": "defs.classifier.lstm",
                        "lstm_params": [16, 2, "defs.fusion_method.avg"]}}]},
           "train": {"batch_size": 1, "epochs": 1,
                     "optimizer": "defs.optim.sgd", "base_lr": 0.01}}
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({"run": run}))
    settings, host = Settings(), Settings()
    feeder = settings.initialize(str(cfg))
    host.initialize(str(cfg))
    model = Model(settings)
    engine = Train(settings, feeder, model, device="cuda")
    prepared = [feed for feed, _, _ in FeedPrefetcher(
        feeder, model.required_input, prepare_fn=engine.prepare_device_feed)]
    ring = next(iter(feeder.get_datasets()[0]._buf_pools.values()))[0]
    assert all(torch.from_numpy(slot[0]).is_pinned() for slot in ring)
    assert len(prepared) == 12
    for feed in prepared:
        want, _ = host.feeder.get_feed(model.required_input)
        for k, v in want.items():
            assert torch.equal(feed[k].cpu(), torch.from_numpy(v)), k
    metrics = engine.run_step(prepared[-1])
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1_dw_shifted_takes_frames_at_a_2_byte_offset(gen, dtype):
    """The kernel copies the 16-byte aligned range that covers its frame
    rows, so frames whose storage starts at any element offset give the
    same bits as an aligned copy."""
    from video_learning_tpu_torch.ops import conv1_dw as c1
    shape = (3, 39, 43, 3)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    gout = torch.randn((3, 10, 11, 96), generator=gen,
                       device="cuda").to(dtype)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    xu = buf[1:].view(shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    assert torch.equal(c1.conv1_dw_shifted(xu, gout),
                       c1.conv1_dw_shifted(x, gout))


class OneRankNcclMesh(Mesh):
    """The mesh of a one-rank NCCL group that reports two ranks, so that
    the port's one-rank shortcuts pass, and runs each reduction on the
    world group, counting those that a capture records (``chip_smoke.py``
    phase 16's mesh)."""

    def __init__(self):
        super().__init__({"data": 1, "model": 1})
        self.size = 2
        self.captured = collections.Counter()

    def _reduce(self, name, t, op):
        if torch.cuda.is_current_stream_capturing():
            self.captured[name] += 1
        dist.all_reduce(t, op=op)
        return t

    def data_sum(self, t):
        return self._reduce("data_sum", t, dist.ReduceOp.SUM)

    def data_max(self, t):
        return self._reduce("data_max", t, dist.ReduceOp.MAX)

    def model_sum(self, t):
        return self._reduce("model_sum", t, dist.ReduceOp.SUM)


@pytest.mark.cuda
def test_graphed_step_on_a_one_rank_nccl_group_equals_eager(gen):
    """A float32 step (dropout 0.5, TF32 off, cuDNN deterministic) on a
    one-rank NCCL mesh: graphs default to on there, the capture holds the
    step's data_sum, and a replay after a restore gives the eager step's
    metrics and state bit for bit."""
    import numpy as np

    from video_learning_tpu_torch.flagship import flagship
    from video_learning_tpu_torch.parallel import launch
    from video_learning_tpu_torch.train import WARMUP_STEPS, Train

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                            % launch.free_port(), world_size=1, rank=0,
                            device_id=device)
    try:
        mesh = OneRankNcclMesh()
        engines = []
        for graphs in (False, None):
            settings, model = flagship(compute_dtype="float32")
            settings.train.dropout_keep_prob = 0.5
            engines.append(Train(settings, settings.feeder, model, seed=0,
                                 device="cuda", graphs=graphs, mesh=mesh))
        eager, graphed = engines
        assert graphed.graphs and not eager.graphs
        rng = np.random.RandomState(31)
        feeds = [{"frames_main_input": (rng.randn(8, 67, 67, 3) * 60)
                  .astype(np.float32),
                  "labels": np.eye(16, dtype=np.int32)[rng.randint(0, 16, 2)]}
                 for _ in range(WARMUP_STEPS + 1)]
        for feed in feeds[:WARMUP_STEPS]:
            graphed.run_step(dict(feed))
        assert mesh.captured == {"data_sum": 1}
        graphed.load_state_dict(eager.state_dict())
        me = eager.run_step(dict(feeds[-1]))
        mg = graphed.run_step(dict(feeds[-1]))
        (program, _), = graphed.graph_cache.programs().values()
        assert program.replays == 1
        assert mg == me
        se, sg = eager.state_dict(), graphed.state_dict()
        for part in ("params", "opt_state_leaves"):
            a, b = se[part], sg[part]
            for k in (a if isinstance(a, dict) else range(len(a))):
                assert torch.equal(a[k], b[k]), (part, k)
    finally:
        dist.destroy_process_group()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
