"""The CUDA kernels on the card, reproject-match, flash attention and int8
matmul (marked ``cuda``; skipped without a card).  Imports no JAX, so it runs where JAX is not installed:

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
     (1, 2, 1, 1, 8, True), (4, 32, 4, 1024, 64, True)],
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
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)

    q = torch.zeros(1, 64, 4, 64, device=device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_pallas(q, q, q)


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
    """One ``forward_int8`` on the card: 8 launches (2 dense 3x3 and 6
    pointwise convolutions), the same output as on the plain version."""
    from repro_torch.core import depth
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas

    g = torch.Generator(device=device).manual_seed(0)
    net = depth.init_params(g)
    calib = torch.rand(4, 64, 64, 3, generator=g, device=device)
    q = depth.quantize_params(net, calib)
    x = torch.rand(1, 64, 64, 3, generator=g, device=device)
    before = int8_matmul_pallas.launches
    out = depth.forward_int8(q, x)
    assert int8_matmul_pallas.launches == before + 8
    q.matmul_backend = "ref"
    assert torch.equal(out, depth.forward_int8(q, x))
    assert int8_matmul_pallas.launches == before + 8
