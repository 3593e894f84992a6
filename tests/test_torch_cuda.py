"""The CUDA kernels on the card: reproject-match, flash attention, int8
matmul and the fused int8 convolution, and the RWKV6 and Mamba-2 SSD scans;
the serving pool, directly and through the wire codec; the checkpoint
store on card tensors; the EVU probe and the MoE/MLA, VLM and
encoder-decoder models against the CPU; training (a train step of every
family against the CPU, the wrappers refusing grad, the depth stage with
cuDNN's switches at PyTorch's defaults) (marked ``cuda``; skipped without
a card).  Imports no JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import geometry as geo
from repro_torch.kernels.reproject_match.fused import (
    reproject_match_fused,
    reproject_match_fused_ref,
)
from repro_torch.kernels.reproject_match.kernel import (
    reproject_match_pallas,
    reproject_match_pallas_tiled,
)
from repro_torch.kernels.reproject_match.ref import reproject_match_ref
from repro_torch.kernels.reproject_match.warp_order import (
    reproject_match_fused_warp_order,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, n, p, hw, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    t_rel = geo.pose_from_rt(
        geo.rotation_xyz(t(rng.normal(scale=0.05, size=(n, 3)))),
        t(rng.normal(scale=0.1, size=(n, 3))),
    ).contiguous()
    args = [
        t(rng.uniform(size=(n, p, p, 3))),
        t(rng.uniform(1.0, 4.0, size=(n, p, p))),
        t(rng.integers(0, hw - p, size=(n, 2))),
        t_rel,
        t(rng.uniform(size=(hw, hw, 3))),
    ]
    return args, geo.Intrinsics.create(0.8 * hw, hw / 2.0, hw / 2.0, device)


@pytest.mark.parametrize(
    "n,p,hw,window",
    [(4, 16, 128, 32), (7, 16, 128, 64), (3, 32, 256, 64), (1, 8, 64, 16),
     (13, 16, 128, 32), (192, 16, 128, 32)],
)
def test_launches_agree_with_each_other_and_the_plain_version(
    device, n, p, hw, window
):
    args, intr = _inputs(device, n, p, hw, n * 7 + p)
    counts = [w.launches for w in (reproject_match_pallas,
                                   reproject_match_pallas_tiled,
                                   reproject_match_fused)]
    plain = reproject_match_fused_ref(*args, intr, window=window, tau=0.3,
                                      o_min=0.5, c_min=0.6)
    a = reproject_match_pallas(*args, intr, window=window)
    b = reproject_match_pallas_tiled(*args, intr, window=window)
    c = reproject_match_fused(*args, intr, window=window, tau=0.3,
                              o_min=0.5, c_min=0.6)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, c[:3]):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert (a[0] - plain[0]).abs().max() <= 1e-5
    assert (a[1] - plain[1]).abs().max() <= 1e-5
    assert (a[2] - plain[2]).abs().max() <= 1e-3
    assert torch.equal(c[3], plain[3]) and torch.equal(c[4], plain[4])
    assert [w.launches for w in (reproject_match_pallas,
                                 reproject_match_pallas_tiled,
                                 reproject_match_fused)] == [
        k + 1 for k in counts]


# The warp per entry at its edges: N ragged against the Pallas grid's 8
# entries a step, P^2 below 32 (idle lanes) up to P = 32 (32 pixels a lane);
# 144x144 frames give M = 81 (rows not 4-byte aligned), 256x256 larger M.
RM_WARP_CASES = (
    [(n, p, 128) for n in (1, 7, 13, 24, 25, 192, 193)
     for p in (2, 3, 5, 8, 16, 32)]
    + [(25, 16, 144), (193, 16, 144), (7, 3, 144), (13, 5, 144),
       (24, 16, 256), (193, 32, 256), (25, 2, 256)]
)


@pytest.mark.parametrize("n,p,hw", RM_WARP_CASES, ids=str)
def test_launches_equal_the_warp_order_plain_version_bitwise(device, n, p,
                                                             hw):
    args, intr = _inputs(device, n, p, hw, n * 31 + p + hw)
    kw = dict(tau=0.34, o_min=0.5, c_min=0.6)
    plain = reproject_match_fused_warp_order(*args, intr, window=32, **kw)
    a = reproject_match_pallas(*args, intr, window=32)
    b = reproject_match_pallas_tiled(*args, intr, window=32)
    c = reproject_match_fused(*args, intr, window=32, **kw)
    torch.cuda.synchronize()
    for x, y, z, w in zip(a, b, c[:3], plain[:3]):
        assert torch.equal(x, y) and torch.equal(x, z) and torch.equal(x, w)
    assert c[3].shape == (n, (hw // p) ** 2)
    assert torch.equal(c[3], plain[3]) and torch.equal(c[4], plain[4])


def test_each_wrapper_is_one_device_launch(device):
    """One CUDA kernel a call, counted by ``torch.profiler``: nothing is
    stacked, copied or set around the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args, intr = _inputs(device, 192, 16, 128, 0)
    calls = {
        "pallas": lambda: reproject_match_pallas(*args, intr, window=32),
        "tiled": lambda: reproject_match_pallas_tiled(*args, intr, window=32),
        "fused": lambda: reproject_match_fused(*args, intr, window=32),
    }
    for name, call in calls.items():
        call()  # builds and loads the library
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        assert sum(e.count for e in rows) == 1, (name, [e.key for e in rows])
        assert "rm_" in rows[0].key, (name, rows[0].key)


def _kernel_divide(a, b):
    """``a / b`` as the reproject-match kernel divides (``div_fast`` where
    its operands are safe, else ``/``)."""
    from repro_torch.kernels._build import check
    from repro_torch.kernels.reproject_match.kernel import LIBRARY, stream_of

    q = torch.empty_like(a)
    check(LIBRARY.library().rm_divide_launch(
        a.data_ptr(), b.data_ptr(), q.data_ptr(), a.numel(),
        stream_of(a.device)), "rm_divide_launch")
    return q


def test_kernel_division_is_ieee_division(device):
    """The kernel's branch-free division equals IEEE division (PyTorch's
    ``a / b`` of two tensors): for every float32 in [2^-60, 8) divided by 3
    (the channel mean's quotients) and for random operands across and
    beyond the safe range (the transform's x / z), zeros of both signs
    included."""
    lo = int(np.float32(2.0 ** -60).view(np.int32))
    hi = int(np.float32(8.0).view(np.int32))
    chunk = 1 << 26
    for start in range(lo, hi, chunk):
        a = torch.arange(start, min(start + chunk, hi), dtype=torch.int32,
                         device=device).view(torch.float32)
        b = torch.full_like(a, 3.0)
        assert torch.equal(_kernel_divide(a, b), a / b), start
    g = torch.Generator(device=device).manual_seed(0)
    for scale in (1.0, 30.0, 90.0):
        a = torch.randn(1 << 24, generator=g, device=device) * torch.exp2(
            (torch.randn(1 << 24, generator=g, device=device) * scale)
            .clamp(-120.0, 120.0))
        b = torch.rand(1 << 24, generator=g, device=device) * 100 + 1e-6
        a[:4] = torch.tensor([0.0, -0.0, 1e-30, -1e30], device=device)
        b[4:8] = torch.tensor([1e-6, 2.0 ** 61, 2.0 ** -61, 1.0],
                              device=device)
        assert torch.equal(_kernel_divide(a, b), a / b), scale
        assert torch.equal(torch.signbit(_kernel_divide(a, b)),
                           torch.signbit(a / b)), scale


def test_wrapper_rejects_a_non_contiguous_tensor(device):
    args, intr = _inputs(device, 4, 16, 128, 0)
    args[0] = args[0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        reproject_match_pallas(*args, intr, window=32)


def test_empty_entry_axis_launches_nothing(device):
    args, intr = _inputs(device, 0, 16, 128, 0)
    before = reproject_match_pallas.launches
    diff, cov, bbox = reproject_match_pallas(*args, intr, window=32)
    assert diff.shape == (0,) and bbox.shape == (0, 4)
    assert reproject_match_pallas.launches == before
    assert reproject_match_ref(*args, intr, 32)[0].shape == (0,)


# ---------------------------------------------------------------------------
# Flash attention: the kernel against its plain version, at the reference's
# gates (2e-5 in float32, 3e-2 in bf16; tests/test_kernels.py:182,196).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,causal",
    [(1, 4, 4, 256, 64, True), (2, 8, 2, 256, 64, True),
     (1, 4, 1, 128, 32, True), (1, 2, 2, 256, 64, False),
     (2, 16, 2, 512, 128, True), (1, 4, 2, 100, 16, True),
     (1, 2, 1, 1, 8, True), (4, 32, 4, 1024, 64, True),
     # head dim 160 (Zamba2-2.7B's shared attention), GQA and MQA, S = 1,
     # 100 and 2048, causal and full; and the sums longest at D = 128
     (2, 8, 8, 256, 160, True), (1, 8, 2, 100, 160, True),
     (2, 4, 1, 1, 160, False), (1, 4, 4, 2048, 160, True),
     (1, 4, 2, 100, 160, False), (1, 8, 8, 2048, 128, True),
     (1, 4, 1, 2048, 32, False)],
)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_kernel_matches_its_plain_version(device, b, hq, hkv, s, d,
                                                causal, dtype, tol):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas, flash_attention_plain)

    g = torch.Generator(device=device).manual_seed(b * 31 + hq + s)
    q, k, v = [torch.randn(b, h, s, d, generator=g, device=device).to(dtype)
               for h in (hq, hkv, hkv)]
    before = flash_attention_pallas.launches
    out = flash_attention_pallas(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_pallas.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = flash_attention_plain(q, k, v, causal=causal)
    assert float((out.float() - plain.float()).abs().max()) <= tol


def test_flash_wrapper_rejects_a_non_contiguous_tensor(device):
    """Only the last dim must be contiguous: a tensor strided there is
    refused (transposed views of the other dims are read as they are)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)

    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 4, 64, 128, dtype=dtype, device=device)[..., ::2]
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention_pallas(q, q, q)


# bf16 on the tensor cores: head dims 64 and 128, GQA groups 1, 4 and 8,
# S = 1, 64, 100, 1024 and 2048, causal and full.
TENSOR_CORE_CASES = [
    (2, 8, 8, 1, 64, True), (2, 8, 2, 64, 64, True),
    (2, 8, 1, 100, 64, True), (4, 32, 4, 1024, 64, True),
    (1, 16, 2, 2048, 64, True), (2, 8, 8, 100, 64, False),
    (2, 8, 2, 1024, 64, False), (2, 8, 8, 1, 128, False),
    (2, 8, 1, 64, 128, True), (2, 8, 2, 100, 128, True),
    (2, 16, 2, 1024, 128, True), (1, 8, 1, 2048, 128, False),
]


def _bshd(device, b, h, s, d, dtype, seed):
    """A (B, H, S, D) view of a (B, S, H, D) buffer: the models' layout."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, s, h, d, generator=g, device=device).to(
        dtype).transpose(1, 2)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", TENSOR_CORE_CASES, ids=str)
def test_flash_tensor_core_matches_its_plain_version(device, b, hq, hkv, s,
                                                     d, causal):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas, flash_attention_plain, route)

    assert route(torch.bfloat16, d) == "tensor_core"
    q, k, v = [_bshd(device, b, h, s, d, torch.bfloat16, i + s + d)
               for i, h in enumerate((hq, hkv, hkv))]
    out = flash_attention_pallas(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    plain = flash_attention_plain(q, k, v, causal=causal)
    assert float((out.float() - plain.float()).abs().max()) <= 3e-2


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 16),
                                     (torch.float32, 128),
                                     (torch.float32, 160),
                                     (torch.bfloat16, 160)])
def test_flash_strided_and_contiguous_inputs_agree_bitwise(device, dtype, d):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)

    q, k, v = [_bshd(device, 2, h, 256, d, dtype, i)
               for i, h in enumerate((8, 2, 2))]
    assert not q.is_contiguous()
    strided = flash_attention_pallas(q, k, v)
    contiguous = flash_attention_pallas(q.contiguous(), k.contiguous(),
                                        v.contiguous())
    assert torch.equal(strided, contiguous)


def test_flash_output_is_a_view_of_a_bshd_buffer(device):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)

    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 32)):
        q = _bshd(device, 2, 4, 128, d, dtype, 0)
        out = flash_attention_pallas(q, q[:, :2], q[:, :2])
        assert out.shape == (2, 4, 128, d)
        assert out.transpose(1, 2).is_contiguous()
        merged = out.transpose(1, 2).reshape(2, 128, 4 * d)
        assert merged.data_ptr() == out.data_ptr()


@pytest.mark.parametrize("dtype,d,expected", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 8, "tf32"), (torch.bfloat16, 32, "tf32"),
    (torch.float32, 64, "tf32"), (torch.float32, 128, "tf32"),
    (torch.float32, 160, "tf32"), (torch.bfloat16, 160, "tf32"),
    (torch.float32, 8, "tf32"), (torch.bfloat16, 16, "tf32"),
])
def test_flash_each_route_launches(device, dtype, d, expected):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas, flash_attention_plain, route)

    assert route(dtype, d) == expected
    q = _bshd(device, 1, 4, 128, d, dtype, d)
    before = flash_attention_pallas.launches
    out = flash_attention_pallas(q, q[:, :1], q[:, :1])
    torch.cuda.synchronize()
    assert flash_attention_pallas.launches == before + 1
    plain = flash_attention_plain(q, q[:, :1], q[:, :1])
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((out.float() - plain.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype,d,pitch", [(torch.float32, 64, 66),
                                           (torch.bfloat16, 160, 164),
                                           (torch.float32, 8, 9)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tf32_reads_unaligned_strides(device, dtype, d, pitch, causal):
    """Rows that are not 16-byte aligned take the 3xTF32 kernel's scalar
    staging (no cp.async) and give the aligned call's values."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas, flash_attention_plain, route)

    assert route(dtype, d) == "tf32"
    g = torch.Generator(device=device).manual_seed(d)
    q, k, v = [torch.randn(2, h, 100, pitch, generator=g, device=device).to(
        dtype)[..., :d] for h in (4, 2, 2)]
    before = flash_attention_pallas.launches
    out = flash_attention_pallas(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_pallas.launches == before + 1
    dense = flash_attention_pallas(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal)
    assert torch.equal(out, dense)
    plain = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((out.float() - plain.float()).abs().max()) <= tol


def test_flash_tensor_core_rejects_unaligned_strides(device):
    """TMA needs 16-byte aligned strides: a row stride of 68 bf16 values
    (136 bytes) is refused before any launch."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)

    q = torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16,
                    device=device)[..., :64]
    before = flash_attention_pallas.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_pallas(q, q, q)
    assert flash_attention_pallas.launches == before


# ---------------------------------------------------------------------------
# int8 matmul: the kernel against its plain version, exactly (the
# reference's gate, tests/test_kernels.py:147), at the reference test's
# shapes, the int8 depth network's eight shapes and ragged edges.
# ---------------------------------------------------------------------------

INT8_SHAPES = [
    (128, 128, 128), (256, 384, 128), (130, 200, 70), (1, 9, 1), (64, 1, 64),
    (1024, 27, 16), (256, 16, 32), (64, 32, 64), (64, 64, 64), (256, 64, 32),
    (1024, 32, 16), (4096, 16, 16), (4096, 144, 1), (65, 33, 129),
    (3000, 1000, 300),
]


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_kernel_equals_its_plain_version(device, m, k, n):
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

    g = torch.Generator(device=device).manual_seed(m + k + n)
    a = torch.randint(-128, 128, (m, k), generator=g, device=device,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=g, device=device,
                      dtype=torch.int8)
    before = int8_matmul_pallas.launches
    out = int8_matmul_pallas(a, b)
    torch.cuda.synchronize()
    assert int8_matmul_pallas.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (m, n)
    assert torch.equal(out, int8_matmul_ref(a, b))


def test_int8_kernel_extremes(device):
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas

    a = torch.full((64, 512), -128, dtype=torch.int8, device=device)
    b = torch.full((512, 64), -128, dtype=torch.int8, device=device)
    out = int8_matmul_pallas(a, b)
    assert bool((out == 512 * 128 * 128).all())


def test_int8_wrapper_rejects_a_non_contiguous_tensor(device):
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas

    a = torch.zeros(16, 16, dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul_pallas(a.t(), a)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul_pallas(a, a[:, :8])


def test_int8_depth_network_launches_eight_kernels(device):
    """One ``forward_int8`` on the card: 8 fused launches (2 dense 3x3 and
    6 pointwise convolutions) and no product-kernel launch, the same
    output, bitwise, as on the plain version."""
    from repro_torch.core import depth
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
    from repro_torch.kernels.int8_matmul.qconv import qconv_int8_pallas

    g = torch.Generator(device=device).manual_seed(0)
    net = depth.init_params(g)
    calib = torch.rand(4, 64, 64, 3, generator=g, device=device)
    q = depth.quantize_params(net, calib)
    x = torch.rand(1, 64, 64, 3, generator=g, device=device)
    counts = (qconv_int8_pallas.launches, int8_matmul_pallas.launches)
    out = depth.forward_int8(q, x)
    assert (qconv_int8_pallas.launches - counts[0],
            int8_matmul_pallas.launches - counts[1]) == (8, 0)
    q.matmul_backend = "ref"
    assert torch.equal(out, depth.forward_int8(q, x))
    assert (qconv_int8_pallas.launches - counts[0],
            int8_matmul_pallas.launches - counts[1]) == (8, 0)


# (input (N, H, W, cin), k, cout, stride, relu): the eight layers of
# forward_int8 at its 64x64 input, then edge cases (odd H and W at stride
# 2, K = 27, N = 1 without ReLU, M = 75, K = 300: two staged tiles).
QCONV_LAYERS = [
    ((1, 64, 64, 3), 3, 16, 2, True), ((1, 16, 16, 16), 1, 32, 1, True),
    ((1, 8, 8, 32), 1, 64, 1, True), ((1, 8, 8, 64), 1, 64, 1, True),
    ((1, 16, 16, 64), 1, 32, 1, True), ((1, 32, 32, 32), 1, 16, 1, True),
    ((1, 64, 64, 16), 1, 16, 1, True), ((1, 64, 64, 16), 3, 1, 1, False),
    ((2, 33, 31, 8), 3, 16, 2, True), ((1, 15, 17, 3), 3, 5, 2, True),
    ((1, 12, 10, 16), 3, 1, 1, False), ((3, 5, 5, 12), 1, 70, 1, True),
    ((1, 9, 7, 300), 1, 9, 1, True),
]


@pytest.mark.parametrize("shape,k,cout,stride,relu", QCONV_LAYERS, ids=str)
@pytest.mark.parametrize("draw", ["normal", "all zero", "half steps"])
def test_qconv_kernel_is_bitwise_its_plain_version(device, shape, k, cout,
                                                   stride, relu, draw):
    """The fused launch against quantise -> im2col -> int8 product ->
    dequantise -> + b -> relu, bitwise; ``"all zero"`` clamps the scale to
    1e-8, ``"half steps"`` (scale 127: a step of 1.0) rounds to even."""
    from repro_torch.kernels.int8_matmul.qconv import (qconv_int8_pallas,
                                                       qconv_int8_ref)

    g = torch.Generator(device=device).manual_seed(sum(shape) + k + cout)
    x = 2 * torch.randn(shape, generator=g, device=device)
    xscale = x.abs().amax()
    if draw == "all zero":
        x.zero_()
        xscale = xscale * 0
    elif draw == "half steps":
        x = torch.round(40 * x) + 0.5
        xscale = torch.tensor(127.0, device=device)
    qw = torch.randint(-127, 128, (k * k * shape[-1], cout), generator=g,
                       device=device, dtype=torch.int8)
    wscale = 1e-3 + 2e-2 * torch.rand(cout, generator=g, device=device)
    b = torch.randn(cout, generator=g, device=device)
    before = qconv_int8_pallas.launches
    out = qconv_int8_pallas(x, xscale, qw, wscale, b, stride=stride,
                            relu=relu)
    torch.cuda.synchronize()
    assert qconv_int8_pallas.launches == before + 1
    want = qconv_int8_ref(x, xscale, qw, wscale, b, stride=stride,
                          relu=relu)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert torch.equal(out, want)


def test_qconv_wrapper_rejects_what_the_kernel_does_not_take(device):
    from repro_torch.kernels.int8_matmul.qconv import qconv_int8_pallas

    x = torch.zeros(1, 8, 8, 16, device=device)
    qw = torch.zeros(16, 4, dtype=torch.int8, device=device)
    ws, b = torch.ones(4, device=device), torch.zeros(4, device=device)
    before = qconv_int8_pallas.launches
    with pytest.raises(ValueError, match="contiguous"):
        qconv_int8_pallas(x.transpose(1, 2), x.amax(), qw, ws, b)
    with pytest.raises(ValueError, match="different devices"):
        qconv_int8_pallas(x, x.amax().cpu(), qw, ws, b)
    assert qconv_int8_pallas.launches == before


# ---------------------------------------------------------------------------
# The RWKV6 and Mamba-2 SSD scans: each kernel against its plain version
# (the chunked form, whose arithmetic it follows) at the reference test's
# shapes and at the full-width shapes, within the reference's gate of 2e-4
# (tests/test_kernels.py:231-232, 263-264); and against the sequential
# oracle at the reference test's shapes in float32.
# ---------------------------------------------------------------------------

SCAN_TOL = 2e-4
RWKV_SHAPES = [(1, 2, 128, 32, 32, 32), (2, 4, 256, 64, 64, 64),
               (1, 1, 64, 16, 48, 16), (1, 2, 192, 64, 64, 64),
               (4, 40, 1024, 64, 64, 32)]
# The kernel's edges (leaves of 8 rows, paired in levels): T = C = 16;
# chunks of 16 over 3 and 5 chunks (V over two column tiles); chunks of 32
# (K not a multiple of 16, nor of 4); chunks of 1, 1.5, 3 and 5 leaves;
# V not a multiple of 4 (the pass and the state's staging element by
# element); K over two tiles of 64 channels, whole (K = V = 128) and the
# second partial (K = 72).
RWKV_EDGE_SHAPES = [(1, 2, 16, 64, 64, 16), (2, 3, 48, 64, 64, 16),
                    (1, 2, 80, 32, 96, 16), (2, 2, 96, 48, 40, 32),
                    (1, 3, 96, 20, 24, 32), (1, 2, 64, 64, 64, 8),
                    (2, 2, 48, 32, 32, 12), (1, 2, 72, 64, 64, 24),
                    (1, 2, 80, 64, 64, 40), (1, 2, 48, 64, 30, 16),
                    (1, 2, 64, 128, 128, 32), (1, 2, 48, 72, 40, 16)]
SSD_SHAPES = [(1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 64),
              (1, 1, 64, 64, 64, 64), (1, 3, 192, 32, 64, 32),
              (1, 2, 63, 80, 16, 64), (2, 3, 96, 24, 40, 32),
              (4, 80, 1024, 64, 64, 64)]


def _rwkv_inputs(device, b, h, t, dk, dv, dtype, strong, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def n(*shape):
        return torch.randn(*shape, generator=g, device=device)

    z = n(b, h, t, dk)
    w = -torch.exp(2.0 * z) if strong else -torch.exp(0.5 * z - 2.0)
    return [x.to(dtype) for x in (0.5 * n(b, h, t, dk), 0.5 * n(b, h, t, dk),
                                  0.5 * n(b, h, t, dv), w, 0.3 * n(h, dk))]


@pytest.mark.parametrize("shape", RWKV_SHAPES + RWKV_EDGE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strong", [False, True])
def test_rwkv6_kernel_matches_its_plain_version(device, shape, dtype,
                                                strong):
    """Against both plain forms: the chunked form and the kernel's own
    decomposition (``rwkv6_scan_chunk_parallel``); o is the view of a
    (B, T, H, V) buffer."""
    from repro_torch.kernels.rwkv6_scan.chunked import (
        rwkv6_scan_chunk_parallel, rwkv6_scan_chunked)
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    *dims, chunk = shape
    args = _rwkv_inputs(device, *dims, dtype, strong, sum(shape))
    before = rwkv6_scan_pallas.launches
    o, s = rwkv6_scan_pallas(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert rwkv6_scan_pallas.launches == before + 1
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    assert o.transpose(1, 2).is_contiguous()  # a (B, T, H, V) buffer
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    for plain in (rwkv6_scan_chunked, rwkv6_scan_chunk_parallel):
        po, ps = plain(*args, chunk=chunk)
        assert float((o - po).abs().max()) <= SCAN_TOL, plain.__name__
        assert float((s - ps).abs().max()) <= SCAN_TOL, plain.__name__
    if dtype == torch.float32 and dims[2] <= 256:
        ro, rs = rwkv6_scan_ref(*args)
        assert float((o - ro).abs().max()) <= SCAN_TOL
        assert float((s - rs).abs().max()) <= SCAN_TOL


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strong", [False, True])
def test_ssd_kernel_matches_its_plain_version(device, shape, dtype, strong):
    from repro_torch.kernels.mamba2_ssd.chunked import mamba2_ssd_chunked
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_ref

    b, h, t, p, n, chunk = shape
    g = torch.Generator(device=device).manual_seed(sum(shape))
    x = 0.5 * torch.randn(b, h, t, p, generator=g, device=device)
    z = torch.randn(b, h, t, generator=g, device=device)
    a = -torch.exp(2.0 * z) if strong else -torch.exp(0.5 * z - 2.0)
    args = [y.to(dtype) for y in (
        x, a, 0.5 * torch.randn(b, t, n, generator=g, device=device),
        0.5 * torch.randn(b, t, n, generator=g, device=device))]
    before = mamba2_ssd_pallas.launches
    y, s = mamba2_ssd_pallas(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba2_ssd_pallas.launches == before + 1
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert y.transpose(1, 2).is_contiguous()  # a (B, T, H, P) buffer
    py, ps = mamba2_ssd_chunked(*args, chunk=chunk)
    assert float((y - py).abs().max()) <= SCAN_TOL
    assert float((s - ps).abs().max()) <= SCAN_TOL
    if dtype == torch.float32 and t <= 256:
        ry, rs = mamba2_ssd_ref(*args)
        assert float((y - ry).abs().max()) <= SCAN_TOL
        assert float((s - rs).abs().max()) <= SCAN_TOL


def test_scan_wrappers_reject_a_non_contiguous_tensor(device):
    """The kernels read through strides, but the last dim must be
    contiguous."""
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas

    r = torch.zeros(1, 2, 16, 64, device=device).transpose(2, 3)
    ok = torch.zeros(1, 2, 64, 16, device=device)
    u = torch.zeros(2, 16, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan_pallas(r, ok, ok, ok, u, chunk=16)
    x = torch.zeros(1, 2, 16, 64, device=device).transpose(2, 3)
    a = torch.zeros(1, 2, 64, device=device)
    bm = torch.zeros(1, 64, 8, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        mamba2_ssd_pallas(x, a, bm, bm, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        mamba2_ssd_pallas(x.contiguous(), a, bm, bm.transpose(1, 2)
                          .contiguous().transpose(1, 2), chunk=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_read_the_models_layout(device, dtype):
    """(B, T, H, .) tensors seen as (B, H, T, .), as the models hand them
    over, and B, C sliced out of a wider row: the same outputs, bitwise,
    as from contiguous copies."""
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas

    g = torch.Generator(device=device).manual_seed(7)

    def bthk(b, t, h, k):
        return torch.randn(b, t, h, k, generator=g, device=device).to(
            dtype).transpose(1, 2)

    r, k, v = (0.5 * bthk(2, 128, 3, 32) for _ in range(3))
    w = -torch.exp(0.5 * bthk(2, 128, 3, 32).float() - 2.0).to(dtype)
    u = 0.3 * torch.randn(3, 32, generator=g, device=device)
    args = (r, k, v, w, u)
    assert not r.is_contiguous()
    got = rwkv6_scan_pallas(*args, chunk=32)
    want = rwkv6_scan_pallas(*(x.contiguous() for x in args), chunk=32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    x = 0.5 * bthk(2, 128, 3, 64)
    a = -torch.exp(0.5 * torch.randn(2, 128, 3, generator=g, device=device)
                   - 2.0).to(dtype).transpose(1, 2)
    bc = 0.5 * torch.randn(2, 128, 48, generator=g, device=device).to(dtype)
    args = (x, a, bc[..., :16], bc[..., 24:40])
    got = mamba2_ssd_pallas(*args, chunk=64)
    want = mamba2_ssd_pallas(*(y.contiguous() for y in args), chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch,wrapper", [
    ("rwkv6-3b", "rwkv6_scan_pallas"), ("zamba2-2.7b", "mamba2_ssd_pallas")])
def test_prefill_on_pallas_launches_one_kernel_per_layer(device, arch,
                                                         wrapper):
    """A smoke-size prefill on ``scan_backend="pallas"``: one launch per
    layer, logits within 1e-4 of the same prefill on ``"chunked"``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
    from repro_torch.models import build_model

    fn = {"rwkv6_scan_pallas": rwkv6_scan_pallas,
          "mamba2_ssd_pallas": mamba2_ssd_pallas}[wrapper]
    cfg = get_smoke_config(arch)
    tokens = torch.randint(0, cfg.vocab, (2, 32), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(0))
    out = {}
    for backend in ("pallas", "chunked"):
        model = build_model(cfg, device=device, scan_backend=backend)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        before = fn.launches
        out[backend] = model.prefill(params, {"tokens": tokens})[0]
        torch.cuda.synchronize()
        assert fn.launches - before == (cfg.n_layers if backend == "pallas"
                                        else 0)
    assert float((out["pallas"] - out["chunked"]).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# The serving pool's slot axis: each kernel on the pool's step, vmapped over
# slots, is one launch whose slot b equals a launch on slot b alone,
# bitwise; the pool's dispatch makes no host sync.
# ---------------------------------------------------------------------------


def _slot_inputs(device, slots, n, p, hw):
    per = [_inputs(device, n, p, hw, seed) for seed in range(slots)]
    intr = per[0][1]
    return [torch.stack(xs) for xs in zip(*(a for a, _ in per))], intr


@pytest.mark.parametrize("wrapper", ["fused", "pallas", "pallas_tiled"])
@pytest.mark.parametrize("slots,n", [(32, 192), (5, 24), (3, 1)])
def test_slot_batched_launch_equals_per_slot_launches(device, wrapper, slots,
                                                      n):
    fn = {"fused": reproject_match_fused, "pallas": reproject_match_pallas,
          "pallas_tiled": reproject_match_pallas_tiled}[wrapper]
    args, intr = _slot_inputs(device, slots, n, 16, 128)

    def call(rgb, depth, origin, t_rel, frame):
        return fn(rgb, depth, origin, t_rel, frame, intr, window=32)

    before = fn.launches
    batched = torch.func.vmap(call)(*args)
    assert fn.launches == before + 1
    for b in range(slots):
        one = call(*(x[b] for x in args))
        for got, want in zip(batched, one):
            assert torch.equal(got[b], want), (wrapper, b)
    # Two vmapped dimensions: two leading slot axes, still one launch.
    nested = torch.func.vmap(torch.func.vmap(call))(
        *(x[None] for x in args))
    assert fn.launches == before + 2 + slots
    for got, want in zip(nested, batched):
        assert torch.equal(got[0], want), wrapper


def test_slot_batched_qconv_keeps_each_slots_scale(device):
    """Per-slot ``amax`` scales: one launch, each slot bitwise its own
    launch (a shared scale would quantise the slots differently)."""
    from repro_torch.kernels.int8_matmul.qconv import qconv_int8_pallas

    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(32, 1, 16, 16, 64, generator=g, device=device)
    x = x * torch.linspace(0.1, 4.0, 32, device=device)[:, None, None, None,
                                                         None]
    qw = torch.randint(-127, 128, (64, 32), generator=g, device=device,
                       dtype=torch.int8)
    ws = 1e-3 + 2e-2 * torch.rand(32, generator=g, device=device)
    b = torch.randn(32, generator=g, device=device)

    def layer(xs):
        return qconv_int8_pallas(xs, xs.abs().amax(), qw, ws, b)

    before = qconv_int8_pallas.launches
    batched = torch.func.vmap(layer)(x)
    assert qconv_int8_pallas.launches == before + 1
    for s in range(32):
        assert torch.equal(batched[s], layer(x[s]))


def _serve_streams(device, n_streams, n_chunks=2, chunk=8, hw=64):
    from repro_torch.api import SensorChunk
    from repro_torch.data import synthetic

    out = []
    for i in range(n_streams):
        s, _ = synthetic.generate_stream(
            np.random.default_rng(i),
            synthetic.StreamConfig(n_frames=n_chunks * chunk, hw=(hw, hw),
                                   n_obj=4), device=device)
        out.append([SensorChunk(*(x[c * chunk:(c + 1) * chunk] for x in (
            s.frames, s.poses, s.gazes, s.depth))) for c in range(n_chunks)])
    return out


def test_server_dispatch_makes_no_host_sync_and_equals_solo(device):
    """Oracle depth on the card: every stream bitwise a solo session; after
    warm-up a tick's dispatch runs under sync-debug mode "error" and
    launches the fused kernel once per frame for all slots."""
    from repro_torch.api import EPICCompressor
    from repro_torch.core import pipeline as pipe
    from repro_torch.serve import ServerConfig, StreamServer

    cfg = pipe.EPICConfig(frame_hw=(64, 64), capacity=32, window=16)
    streams = _serve_streams(device, 6, n_chunks=3)
    srv = StreamServer(EPICCompressor(cfg, device=device),
                       ServerConfig(capacity=8, chunk_frames=8))
    for i in range(6):
        srv.admit(i)
    for c in range(3):
        for i, chunks in enumerate(streams):
            srv.submit(i, chunks[c])
        if c == 0:
            srv.tick()  # builds the step program
            continue
        ready = srv._pop_ready()
        before = reproject_match_fused.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            inflight = srv._dispatch(ready)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        srv._finish(*inflight)
        assert reproject_match_fused.launches - before == 8
    for i, chunks in enumerate(streams):
        solo = EPICCompressor(cfg, device=device)
        state = solo.init()
        for c in chunks:
            state, _ = solo.step(state, c)
        for got, want in zip(torch.utils._pytree.tree_leaves(srv.state(i)),
                             torch.utils._pytree.tree_leaves(state)):
            assert torch.equal(got, want), i


def test_codec_decodes_to_card_tensors_bitwise(device):
    """A chunk of card tensors (every field dtype the serving path uses,
    bfloat16 among them) encodes with one fetch to the host and decodes to
    views whose copy on the card is bitwise the original."""
    from repro_torch.api import SensorChunk
    from repro_torch.wire import codec

    g = torch.Generator(device=device).manual_seed(0)
    chunk = SensorChunk(
        torch.rand((8, 64, 64, 3), generator=g, device=device),
        torch.rand((8, 4, 4), generator=g, device=device,
                   dtype=torch.float64),
        torch.rand((8, 2), generator=g, device=device).to(torch.bfloat16),
        torch.randint(0, 255, (8, 64, 64), generator=g, device=device,
                      dtype=torch.uint8),
    )
    msg = codec.encode_chunk(chunk, stream_id=3, seq=1, timestamp_ns=2)
    back = codec.decode_frame(msg).chunk
    for a, b in zip(chunk, back):
        assert b.device.type == "cpu" and b.dtype == a.dtype
        assert torch.equal(b.to(device), a)


def test_pool_served_through_loopback_equals_direct_submit(device):
    """Oracle depth on the card: the same chunks through EPWF bytes,
    ``Loopback`` and a strict-seq ``IngestServer`` end bitwise equal to
    direct ``submit``; a backpressured frame copies nothing to the card."""
    from repro_torch.api import EPICCompressor
    from repro_torch.core import pipeline as pipe
    from repro_torch.serve import ServerConfig, StreamServer
    from repro_torch.wire import codec
    from repro_torch.wire.server import IngestServer, Loopback

    cfg = pipe.EPICConfig(frame_hw=(64, 64), capacity=32, window=16)
    streams = _serve_streams(device, 4, n_chunks=3)
    servers = [StreamServer(EPICCompressor(cfg, device=device),
                            ServerConfig(capacity=8, chunk_frames=8))
               for _ in range(2)]
    direct, wired = servers
    loop = Loopback(IngestServer(wired, strict_seq=True))
    for i in range(4):
        direct.admit(i)
        assert loop.send(codec.encode_control(codec.OP_OPEN, i)).ok
    for c in range(3):
        for i, chunks in enumerate(streams):
            assert direct.submit(i, chunks[c])
            assert loop.send(codec.encode_chunk(chunks[c], stream_id=i,
                                                seq=c, timestamp_ns=c)).ok
        direct.tick()
        loop.ingest.tick()
    for i in range(4):
        for got, want in zip(torch.utils._pytree.tree_leaves(wired.state(i)),
                             torch.utils._pytree.tree_leaves(direct.state(i))):
            assert torch.equal(got, want), i
    for seq in range(3, 5):
        assert loop.send(codec.encode_chunk(streams[0][0], stream_id=0,
                                            seq=seq, timestamp_ns=0)).ok
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    r = loop.send(codec.encode_chunk(streams[0][0], stream_id=0, seq=5,
                                     timestamp_ns=0))
    assert r.status_name == "backpressure"
    assert torch.cuda.max_memory_allocated(device) == before


def test_store_round_trips_card_tensors(device, tmp_path):
    from repro_torch.checkpoint import store

    g = torch.Generator(device=device).manual_seed(1)
    tree = {"w": torch.randn((64, 32), generator=g, device=device),
            "b": torch.randn((32,), generator=g,
                             device=device).to(torch.bfloat16),
            "n": torch.arange(5, device=device, dtype=torch.int32),
            "flags": torch.rand(7, generator=g, device=device) < 0.5,
            "step": 3}
    want = {k: v.clone() for k, v in tree.items() if k != "step"}
    saver = store.AsyncSaver()
    saver.save(str(tmp_path), 1, tree)
    tree["w"].add_(1.0)  # the snapshot was taken at the call
    saver.wait()
    out, step = store.restore(str(tmp_path), tree)
    assert step == 1 and out["step"] == 3
    for k, v in want.items():
        assert out[k].device == v.device and out[k].dtype == v.dtype
        assert torch.equal(out[k], v), k


def test_evu_on_the_card_matches_the_cpu(device):
    """``forward``, ``loss_fn``'s gradient and one Adam update on the card
    within 1e-5 of the same calls on the CPU (TF32 off), the logits and
    gradients relative to their largest entry where it exceeds 1 (cuBLAS
    and the CPU sum the products in other orders).  The update is held on
    one gradient, the CPU's: Adam's first step is ``lr * g / (|g| + eps)``,
    so a gradient entry within rounding of 0 may take either sign."""
    from repro_torch.core import evu
    from repro_torch.core.packing import TOKEN_FEAT

    cfg = evu.EVUConfig(d_model=64, n_classes=5, n_segments=4, batch=16,
                        lr=2e-3)
    p = evu.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    g = torch.Generator(device=device).manual_seed(1)
    batch = {
        "tokens": torch.rand((16, 48, TOKEN_FEAT), generator=g,
                             device=device),
        "mask": torch.rand((16, 48), generator=g, device=device) < 0.8,
        "seg": torch.randint(0, 4, (16,), generator=g, device=device,
                             dtype=torch.int32),
        "label": torch.randint(0, 5, (16,), generator=g, device=device,
                               dtype=torch.int32),
    }
    p_cpu = evu.tree_map(lambda x: x.cpu(), p)
    cpu = {k: x.cpu() for k, x in batch.items()}
    want = evu.forward(p_cpu, cpu["tokens"], cpu["mask"], cpu["seg"], cfg)
    torch.testing.assert_close(
        evu.forward(p, batch["tokens"], batch["mask"], batch["seg"],
                    cfg).cpu(),
        want, atol=1e-5 * max(1.0, float(want.abs().max())), rtol=0)
    _, grads = evu.grad(p, batch, cfg)
    _, grads_cpu = evu.grad(p_cpu, cpu, cfg)
    for a, b in zip(evu.leaves(grads), evu.leaves(grads_cpu)):
        torch.testing.assert_close(
            a.cpu(), b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)
    zeros = evu.tree_map(torch.zeros_like, p)
    zeros_cpu = evu.tree_map(torch.zeros_like, p_cpu)
    g = evu.tree_map(lambda x: x.to(device), grads_cpu)
    for i in (0, 7):
        got = evu.adam_update(p, zeros, zeros, g, i, cfg)
        want = evu.adam_update(p_cpu, zeros_cpu, zeros_cpu, grads_cpu, i,
                               cfg)
        for x, y in zip(got, want):
            for a, b in zip(evu.leaves(x), evu.leaves(y)):
                torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The MoE/MLA, VLM and encoder-decoder answer paths: the card against the
# CPU on the same weights.
# ---------------------------------------------------------------------------

ZOO_ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b",
             "llama-3.2-vision-11b", "seamless-m4t-large-v2")


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_zoo_on_the_card_matches_the_cpu(device, arch, backend):
    """The smoke config in float32 with a float32 cache, the same weights
    (the VLM's gates drawn nonzero) on the card and on the CPU: forward
    and prefill logits within 1e-4, 4 greedy tokens equal (from position
    0 for the encoder-decoder, whose prefill runs the encoder only).  On
    ``"pallas"`` the VLM's and SeamlessM4T's self-attention launch the
    flash kernel on the card (its plain version on the CPU); DeepSeek's
    MLA has no kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)
    from repro_torch.models import build_model
    from repro_torch.serve.efm import greedy_decode_loop, pad_for_decode

    cfg = get_smoke_config(arch).replace(cache_dtype="float32",
                                         attn_backend=backend)
    models = {"cpu": build_model(cfg, device="cpu"),
              "cuda": build_model(cfg, device=device)}
    params = models["cpu"].init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    if cfg.family == "vlm":
        for key in ("gate_attn", "gate_mlp"):
            g = params["xattn_layers"][key]
            params["xattn_layers"][key] = torch.rand(g.shape,
                                                     generator=gen) + 0.5
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    if cfg.family == "vlm":
        batch["img_embed"] = torch.randn(2, 12, cfg.d_model, generator=gen)
    if cfg.family == "encdec":
        batch["src_embed"] = torch.randn(2, 64, cfg.d_model, generator=gen)
    out = {}
    for where, model in models.items():
        p = _tree_to(params, model.device)
        b = {k: v.to(model.device) for k, v in batch.items()}
        before = flash_attention_pallas.launches
        full = model.forward(p, b)
        logits, state = model.prefill(p, b)
        if logits is None:
            first, start = b["tokens"][:, :1].to(torch.int32), 0
        else:
            first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            start = b["tokens"].shape[1]
            state = pad_for_decode(model, state, 4)
        tokens, _ = greedy_decode_loop(model, p, state, first, start, 4)
        out[where] = (full.cpu(), None if logits is None else logits.cpu(),
                      tokens.cpu(), flash_attention_pallas.launches - before)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4,
                               rtol=0)
    if out["cpu"][1] is not None:
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-4,
                                   rtol=0)
    assert torch.equal(out["cuda"][2], out["cpu"][2])
    # forward + prefill: every self layer twice; the encoder-decoder's
    # prefill runs its encoder only.
    launches = {"vlm": 2 * cfg.n_layers,
                "encdec": 2 * cfg.enc_layers + cfg.dec_layers}
    assert out["cuda"][3] == (launches.get(cfg.family, 0)
                              if backend == "pallas" else 0)
    assert out["cpu"][3] == 0


# ---------------------------------------------------------------------------
# Training: the wrappers under grad, a train step against the CPU, and the
# depth stage with cuDNN at PyTorch's defaults.
# ---------------------------------------------------------------------------


def _refuses(wrapper, call):
    """``call()`` raises the grad refusal and launches nothing."""
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    assert wrapper.launches == before


def test_every_wrapper_refuses_grad_on_the_card(device):
    """An input that requires grad stops each wrapper before its launch
    (a launch would return a tensor without a ``grad_fn``); under
    ``no_grad`` the same call launches."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)
    from repro_torch.kernels.int8_matmul.qconv import qconv_int8_pallas
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas

    def rand(*shape, grad=False):
        return torch.rand(shape, device=device).requires_grad_(grad)

    args, intr = _inputs(device, 4, 16, 128, 3)
    qw = torch.randint(-127, 128, (72, 8), dtype=torch.int8, device=device)
    calls = {
        flash_attention_pallas: lambda g: flash_attention_pallas(
            rand(1, 4, 128, 64, grad=g), rand(1, 4, 128, 64),
            rand(1, 4, 128, 64)),
        rwkv6_scan_pallas: lambda g: rwkv6_scan_pallas(
            rand(1, 2, 64, 16, grad=g), rand(1, 2, 64, 16),
            rand(1, 2, 64, 16), -rand(1, 2, 64, 16), rand(2, 16), chunk=32),
        mamba2_ssd_pallas: lambda g: mamba2_ssd_pallas(
            rand(1, 2, 64, 16, grad=g), -rand(1, 2, 64), rand(1, 64, 16),
            rand(1, 64, 16), chunk=32),
        qconv_int8_pallas: lambda g: qconv_int8_pallas(
            rand(1, 16, 16, 8, grad=g), rand() + 0.1, qw, rand(8), rand(8)),
        reproject_match_pallas: lambda g: reproject_match_pallas(
            args[0].clone().requires_grad_(g), *args[1:], intr, window=32),
        reproject_match_pallas_tiled: lambda g: reproject_match_pallas_tiled(
            args[0].clone().requires_grad_(g), *args[1:], intr, window=32),
        reproject_match_fused: lambda g: reproject_match_fused(
            args[0].clone().requires_grad_(g), *args[1:], intr, window=32),
    }
    for wrapper, call in calls.items():
        _refuses(wrapper, lambda: call(True))
        before = wrapper.launches
        with torch.no_grad():
            call(True)
        call(False)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2, wrapper.__name__


@pytest.mark.parametrize("arch,backend", [("tinyllama-1.1b", "attn"),
                                          ("zamba2-2.7b", "attn"),
                                          ("rwkv6-3b", "scan"),
                                          ("zamba2-2.7b", "scan")])
def test_a_loss_on_a_kernel_raises_on_the_card(device, arch, backend):
    """A loss on ``attn_backend="pallas"``, or a prefill on
    ``scan_backend="pallas"``, under grad raises at the launch instead of
    returning a result whose gradient lost the kernel's op."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
    from repro_torch.launch import train
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch)
    tokens = {"tokens": torch.randint(0, cfg.vocab, (2, 64), device=device)}
    if backend == "attn":
        model = build_model(cfg.replace(attn_backend="pallas"),
                            device=device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        _refuses(flash_attention_pallas,
                 lambda: train.value_and_grad(model.loss_fn, params, tokens))
        return
    model = build_model(cfg, device=device, scan_backend="pallas")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    live = {k: _tree_map_live(v) for k, v in params.items()}
    wrapper = (rwkv6_scan_pallas if cfg.family == "rwkv6"
               else mamba2_ssd_pallas)
    _refuses(wrapper, lambda: model.prefill(live, tokens))


def _tree_map_live(tree):
    if isinstance(tree, dict):
        return {k: _tree_map_live(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


@pytest.mark.parametrize("arch", [
    "olmo-1b", "tinyllama-1.1b", "qwen2.5-3b", "phi4-mini-3.8b",
    "deepseek-v2-lite-16b", "deepseek-v3-671b", "rwkv6-3b", "zamba2-2.7b",
    "llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_train_step_on_the_card_matches_the_cpu(device, arch):
    """One float32 AdamW step of the smoke config from the same state on
    the card and on the CPU: loss and gradient norm within 1e-4
    relative, the first moments (the clipped gradients g, times 1 - b1)
    within 1e-4 of their scale, and the parameters within what such a
    gradient can move them: the first step moves an element by
    lr g / (|g| + eps), so by at most lr eps 1e-4 max|g| / (|g| + eps)^2,
    never more than 2 lr (an element whose gradient is a rounding
    residue, below 1e-4 of the leaf's largest, may move either way),
    plus 1e-6 of the leaf's largest |p|."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models import encdec
    from repro_torch.optim import adamw

    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg, device="cpu").init(gen)
    if cfg.family == "vlm":
        for key in ("gate_attn", "gate_mlp"):
            g = params["xattn_layers"][key]
            params["xattn_layers"][key] = torch.rand(g.shape,
                                                     generator=gen) + 0.5
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
    if cfg.family == "vlm":
        batch["img_embed"] = 0.1 * torch.randn(2, cfg.img_seq, cfg.d_model,
                                               generator=gen)
    if cfg.family == "encdec":
        batch["src_embed"] = 0.1 * torch.randn(
            2, encdec.src_len(cfg, 16), cfg.d_model, generator=gen)
    lr, tol, out = 1e-3, 1e-4, {}
    for where in ("cpu", device):
        model = build_model(cfg, device=where)
        p = _tree_to(params, model.device)
        step = train.make_train_step(model, adamw.AdamWConfig(lr=lr),
                                     warmup_steps=0)
        out[str(model.device.type)] = step(
            p, adamw.init(p), {k: v.to(model.device) for k, v in
                               batch.items()}, 0)
    (p0, o0, m0), (p1, o1, m1) = out["cpu"], out["cuda"]
    for k in ("loss", "gnorm"):
        assert abs(float(m1[k]) - float(m0[k])) <= tol * abs(float(m0[k]))
    for a, b in zip(pytree.tree_leaves(o0.mu), pytree.tree_leaves(o1.mu)):
        assert float((b.cpu() - a).abs().max()) <= tol * float(
            a.abs().max())
    for a, m, b in zip(*(pytree.tree_leaves(t) for t in (p0, o0.mu, p1))):
        g = m.abs() / 0.1
        top = float(g.max())
        moved = (lr * 1e-8 * tol * top / (g + 1e-8) ** 2).clamp(max=2 * lr)
        allowed = torch.where(g >= 1e-4 * top, moved,
                              torch.full_like(g, 2 * lr))
        assert bool(((b.cpu() - a).abs() <= allowed + 1e-6 * float(
            a.abs().max())).all())


def test_depth_stage_with_cudnn_at_its_defaults_matches_the_cpu(device):
    """With cuDNN's switches at PyTorch's defaults (TF32 allowed, not
    deterministic), ``conv2d_same`` still convolves in full float32: the
    fp32 depth stage and HIR within 1e-5 of the CPU (the parity tests'
    rule), the gradient of ``depth.loss_fn`` within 1e-4 of each weight's
    largest; the switches are as they were after."""
    from repro_torch.core import depth as depth_mod
    from repro_torch.core import hir as hir_mod

    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    gen = torch.Generator().manual_seed(0)
    nets = {"cpu": (depth_mod.init_params(gen), hir_mod.init_params(gen))}
    nets["cuda"] = tuple(type(n)(torch.Generator().manual_seed(1)).to(device)
                         for n in nets["cpu"])
    for a, b in zip(nets["cpu"], nets["cuda"]):
        b.load_state_dict(a.state_dict())
    frame = torch.rand((128, 128, 3), generator=gen)
    rgb = torch.rand((4, 64, 64, 3), generator=gen)
    heat = torch.rand((4, 64, 64), generator=gen)
    target = 1.0 + 3.0 * torch.rand((4, 64, 64), generator=gen)
    out = {}
    try:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = (
            True, False, False)
        for where, (dnet, hnet) in nets.items():
            dev = next(dnet.parameters()).device
            with torch.no_grad():
                d = depth_mod.predict_fullres(dnet, frame.to(dev))
                h = hir_mod.forward(hnet, rgb.to(dev), heat.to(dev), 4)
            depth_mod.loss_fn(dnet, rgb.to(dev), target.to(dev)).backward()
            out[where] = (d.cpu(), h.cpu(),
                          [p.grad.cpu() for p in dnet.parameters()])
        assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-5)
    for a, b in zip(out["cpu"][2], out["cuda"][2]):
        assert float((b - a).abs().max()) <= 1e-4 * float(a.abs().max())



def test_one_rank_nccl_decode_equals_one_device(device):
    """``jit_decode_step`` on ``make_host_mesh()`` (a one-rank NCCL group)
    gives the ``mesh=None`` step's logits, bitwise, for 4 greedy tokens of
    TinyLlama's smoke configuration from one prefill."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import efm

    created = not dist.is_initialized()
    try:
        mesh = make_host_mesh(device=device)
        assert dist.get_backend() == "nccl"
        cfg = get_smoke_config("tinyllama-1.1b").replace(
            cache_dtype="float32")
        model = build_model(cfg, device=device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        tokens = torch.randint(0, cfg.vocab, (2, 8), device=device,
                               generator=torch.Generator(
                                   device=device).manual_seed(1))
        _, cache = efm.jit_prefill(model)(params, {"tokens": tokens})
        new = 4
        plain = efm.jit_decode_step(model)
        sharded, specs = efm.jit_decode_step(
            model, mesh, ShapeSpec("x", "decode", 8 + new, 2))
        assert set(specs) == {"params", "state", "token"}
        a = efm.pad_for_decode(model, cache, new)
        b = {k: v.clone() for k, v in a.items()}
        tok = tokens[:, -1:]
        for i in range(new):
            la, a = plain(params, a, tok, 8 + i)
            lb, b = sharded(params, b, tok, 8 + i)
            b = {k: v.full_tensor() for k, v in b.items()}
            assert torch.equal(la, lb.full_tensor()), i
            tok = torch.argmax(la[:, -1:], dim=-1).to(torch.int32)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
