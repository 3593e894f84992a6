"""Flash attention in the PyTorch port against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package's
``attention_ref`` and ``flash_attention_pallas(..., interpret=True)`` and
through the port's plain version (what the kernel wrapper takes for CPU
tensors) and its ``ops.attention`` dispatcher.  Tolerances are the
reference's own gates (``tests/test_kernels.py``): 2e-5 in float32 (the
two sum the softmax in different block orders, a few ulps of values of
order 1), 3e-2 for bf16 inputs (a bf16 output rounds at 2^-8 relative).

The ``"tf32"`` kernel's arithmetic (3xTF32 products, tiles of 32 keys) is
held to the same gates through ``flash_attention_3xtf32_plain``, and its
TF32 rounding (``cvt.rna``) bitwise to a scalar reference in exact
rational arithmetic.
"""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch
from repro.kernels.flash_attention.kernel import (
    flash_attention_pallas as jax_flash,
)
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIMS,
    TENSOR_CORE_HEAD_DIMS,
    flash_attention_3xtf32_plain,
    flash_attention_pallas,
    flash_attention_plain,
    kernel_strides,
    round_tf32,
    route,
    split_tf32,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

F32_TOL = 2e-5  # tests/test_kernels.py:182
BF16_TOL = 3e-2  # tests/test_kernels.py:196


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


# The reference's parametrisation (tests/test_kernels.py:161-172), plus
# S < 128 and S = 1 (one block of the whole sequence) and head dims 8, 16.
CASES = [
    (1, 4, 4, 256, 64, True),
    (2, 8, 2, 256, 64, True),  # GQA group 4
    (1, 4, 1, 128, 32, True),  # MQA
    (1, 2, 2, 256, 64, False),
    (2, 16, 2, 512, 128, True),  # production-ish head geometry
    (1, 4, 2, 100, 16, True),
    (1, 2, 1, 1, 8, True),
    (2, 6, 3, 64, 8, False),
    (1, 2, 2, 128, 160, True),  # Zamba2-2.7B's shared attention head dim
    (1, 4, 4, 100, 160, False),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", CASES)
def test_kernel_contract_matches_jax(b, hq, hkv, s, d, causal):
    q, k, v = _qkv(b * 31 + hq + s, b, hq, hkv, s, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(to_torch, (q, k, v))
    ref = np.asarray(jax_ref(jq, jk, jv, causal=causal))
    pal = np.asarray(jax_flash(jq, jk, jv, causal=causal, interpret=True))
    plain = to_numpy(flash_attention_plain(tq, tk, tv, causal=causal))
    launches = flash_attention_pallas.launches
    wrapped = to_numpy(flash_attention_pallas(tq, tk, tv, causal=causal))
    assert flash_attention_pallas.launches == launches  # CPU: plain version
    np.testing.assert_array_equal(plain, wrapped)
    np.testing.assert_allclose(plain, pal, atol=F32_TOL)
    np.testing.assert_allclose(plain, ref, atol=F32_TOL)
    for backend in ("ref", "pallas"):
        out = ops.attention(tq, tk, tv, causal=causal, backend=backend)
        np.testing.assert_allclose(to_numpy(out), ref, atol=F32_TOL)


def test_ref_matches_jax_ref_in_bf16():
    """The oracle forms its logits in the inputs' dtype, as the
    reference's does; both then run an f32 softmax."""
    q, k, v = _qkv(7, 1, 4, 2, 128, 64)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    ref = np.asarray(jax_ref(*bf), dtype=np.float32)
    out = attention_ref(*[to_torch(np.asarray(x.astype(jnp.float32))).bfloat16()
                          for x in bf])
    assert out.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(out), ref, atol=BF16_TOL)


def test_bf16_io_matches_jax():
    """tests/test_kernels.py:186-199: bf16 in, bf16 out, f32 inside."""
    q, k, v = _qkv(3, 1, 4, 4, 256, 64)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    exact = np.asarray(jax_ref(*[x.astype(jnp.float32) for x in bf]))
    pal = np.asarray(jax_flash(*bf, interpret=True), dtype=np.float32)
    tq, tk, tv = [to_torch(np.asarray(x.astype(jnp.float32))).bfloat16()
                  for x in bf]
    out = flash_attention_pallas(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    out = to_numpy(out.float())
    np.testing.assert_allclose(out, exact, atol=BF16_TOL)
    np.testing.assert_allclose(out, pal, atol=BF16_TOL)


@pytest.mark.parametrize(
    "shapes,dtypes,error",
    [
        (((1, 4, 256, 64), (1, 3, 256, 64)), None, ValueError),  # 4 % 3
        (((1, 4, 200, 64), (1, 2, 200, 64)), None, ValueError),  # S % 128
        (((1, 4, 64, 64), (1, 2, 32, 64)), None, ValueError),  # k's S
        (((4, 64, 64), (1, 2, 64, 64)), None, ValueError),  # 3-D q
        (((1, 4, 64, 64), (1, 2, 64, 64)),
         (torch.float32, torch.bfloat16), TypeError),
        (((1, 4, 64, 64), (1, 2, 64, 64)),
         (torch.float16, torch.float16), TypeError),
    ],
)
def test_wrapper_rejects_what_the_contract_excludes(shapes, dtypes, error):
    qs, ks = shapes
    qd, kd = dtypes or (torch.float32, torch.float32)
    q = torch.zeros(qs, dtype=qd)
    k = torch.zeros(ks, dtype=kd)
    with pytest.raises(error):
        flash_attention_pallas(q, k, k)


def test_dispatcher_rejects_an_unknown_backend():
    q = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.attention(q, q, q, backend="bogus")


# ---------------------------------------------------------------------------
# The card's two instances and the strided layout, as far as the CPU sees
# them: the routing function, the strides handed to the kernels, and the
# wrapper on the models' (B, S, H, D)-backed views.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_picks_the_instance_for_every_dtype_and_head_dim(dtype, d):
    expected = ("tensor_core" if dtype == torch.bfloat16
                and d in TENSOR_CORE_HEAD_DIMS else "tf32")
    assert route(dtype, d) == expected


@pytest.mark.parametrize("dtype,d,error", [(torch.float16, 64, TypeError),
                                           (torch.bfloat16, 48, ValueError),
                                           (torch.float32, 48, ValueError)])
def test_route_refuses_what_no_instance_takes(dtype, d, error):
    with pytest.raises(error):
        route(dtype, d)


def _bshd(x, dtype=torch.float32):
    """numpy (B, H, S, D) -> the same values as the (B, H, S, D) view of a
    (B, S, H, D) tensor: the layout the models hand the kernel."""
    return to_torch(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).to(
        dtype).transpose(1, 2)


def test_kernel_strides_of_the_models_layout():
    q = torch.zeros(2, 100, 8, 64).transpose(1, 2)  # (B, H, S, D) view
    assert kernel_strides(q) == (100 * 8 * 64, 64, 8 * 64)
    assert kernel_strides(torch.zeros(2, 8, 100, 64)) == (51200, 6400, 64)
    # a dim of size 1 takes the contiguous stride, whatever PyTorch left
    one = torch.zeros(1, 1, 8, 64).transpose(1, 2)  # (1, 8, 1, 64)
    assert kernel_strides(one) == (8 * 64, 64, 64)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [
    (2, 8, 2, 256, 64, True), (1, 4, 4, 100, 128, False),
    (2, 6, 3, 64, 16, True), (1, 2, 1, 1, 64, True)])
def test_wrapper_on_the_models_strided_views(b, hq, hkv, s, d, causal):
    """On the CPU the wrapper takes its plain version; the strided views
    give the contiguous call's values, and the JAX kernel's."""
    q, k, v = _qkv(s + d, b, hq, hkv, s, d)
    tq, tk, tv = map(_bshd, (q, k, v))
    assert s == 1 or not tq.is_contiguous()  # S = 1: a view that is both
    strided = flash_attention_pallas(tq, tk, tv, causal=causal)
    contiguous = flash_attention_pallas(*map(to_torch, (q, k, v)),
                                        causal=causal)
    np.testing.assert_array_equal(to_numpy(strided), to_numpy(contiguous))
    pal = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                               interpret=True))
    np.testing.assert_allclose(to_numpy(strided), pal, atol=F32_TOL)


def test_wrapper_on_bf16_strided_views_matches_jax():
    q, k, v = _qkv(11, 1, 8, 2, 128, 64)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    pal = np.asarray(jax_flash(*bf, interpret=True), dtype=np.float32)
    views = [_bshd(np.asarray(x.astype(jnp.float32)), torch.bfloat16)
             for x in bf]
    out = flash_attention_pallas(*views)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(out.float()), pal, atol=BF16_TOL)


def test_attention_full_hands_the_kernel_uncopied_views(monkeypatch):
    """``backend="pallas"`` passes the projections' (B, S, H, D)-backed
    views as they are (no ``.contiguous()`` copy before the launch)."""
    from repro_torch.models import layers

    seen = {}

    def spy(q, k, v, *, causal):
        seen.update(q=q, k=k, v=v)
        return flash_attention_plain(q, k, v, causal=causal)

    monkeypatch.setattr(layers, "flash_attention_pallas", spy)
    gen = torch.Generator().manual_seed(0)
    p = layers.init_attention(gen, 64, 4, 2, 16)
    x = torch.randn(2, 32, 64, generator=gen)
    out = layers.attention_full(p, x, 4, 2, backend="pallas")
    ref = layers.attention_full(p, x, 4, 2, backend="ref")
    v = seen["v"]
    assert v.shape == (2, 2, 32, 16) and not v.is_contiguous()
    assert v.transpose(1, 2).is_contiguous()  # the projection's own memory
    np.testing.assert_allclose(to_numpy(out), to_numpy(ref), atol=1e-5)


def test_bf16_io_at_head_dim_160_matches_jax():
    """Zamba2-2.7B's shared attention: bf16 at head dim 160 (the "tf32"
    instance on the card), against the Pallas kernel in interpret mode."""
    q, k, v = _qkv(5, 1, 4, 4, 128, 160)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    pal = np.asarray(jax_flash(*bf, interpret=True), dtype=np.float32)
    out = flash_attention_pallas(*[_bshd(np.asarray(x.astype(jnp.float32)),
                                         torch.bfloat16) for x in bf])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(out.float()), pal, atol=BF16_TOL)


# ---------------------------------------------------------------------------
# The "tf32" kernel's arithmetic on the CPU: TF32 splits and 3xTF32 tiles.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,s,d,causal",
                         CASES + [(1, 4, 2, 2048, 128, True)])
def test_3xtf32_plain_matches_jax(b, hq, hkv, s, d, causal):
    """3xTF32 keeps the float32 gate, also where the sums are longest
    (S = 2048, D = 128)."""
    q, k, v = _qkv(b * 31 + hq + s, b, hq, hkv, s, d)
    pal = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                               interpret=True))
    out = flash_attention_3xtf32_plain(*map(to_torch, (q, k, v)),
                                       causal=causal)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(out), pal, atol=F32_TOL)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [
    (1, 4, 2, 100, 16, True), (1, 2, 2, 128, 160, True),
    (2, 6, 3, 64, 8, False)])
def test_3xtf32_plain_in_bf16_matches_jax(b, hq, hkv, s, d, causal):
    """bf16: Q K^T as one exact product, P V as two."""
    q, k, v = _qkv(s + d, b, hq, hkv, s, d)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    pal = np.asarray(jax_flash(*bf, causal=causal, interpret=True),
                     dtype=np.float32)
    out = flash_attention_3xtf32_plain(
        *[to_torch(np.asarray(x.astype(jnp.float32))).bfloat16() for x in bf],
        causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(out.float()), pal, atol=BF16_TOL)


_F32_MAX = Fraction(2) ** 127 * (2 - Fraction(2) ** -23)


def _cvt_rna_scalar(bits: int) -> int:
    """``cvt.rna.tf32.f32`` of the float32 with these bits, in exact
    rational arithmetic: round the magnitude to the TF32 grid (spacing
    2^(e - 10) in the binade [2^e, 2^(e+1)), 2^-136 among subnormals),
    ties away from zero; past the largest float32, inf."""
    x = float(np.array([bits], np.uint32).view(np.float32)[0])
    if x == 0 or math.isinf(x):
        return bits
    a = Fraction(abs(x))
    e = max(math.frexp(abs(x))[1] - 1, -126)
    unit = Fraction(2) ** (e - 10)
    n = a / unit
    r = math.floor(n) + (1 if n - math.floor(n) >= Fraction(1, 2) else 0)
    val = r * unit
    y = math.inf if val > _F32_MAX else float(val)
    return int(np.array([math.copysign(y, x)], np.float32).view(np.uint32)[0])


_EDGE_BITS = [
    0x00000000, 0x80000000,  # +-0
    0x3F801000, 0xBF801000,  # ties: 1 + 2^-11, and negated
    0x3F803000, 0x3F800FFF, 0x3F801001, 0x3F802FFF,  # tie above, near ties
    0x3FFFF000, 0xBFFFF000,  # a tie that carries into the exponent
    0x00000001, 0x00000FFF, 0x00001000, 0x00001001, 0x80001000,  # subnormal
    0x00003000, 0x007FF000, 0x007FFFFF,  # to the smallest normal
    0x00800000, 0x00801000,  # smallest normal, a tie on it
    0x7F7FE000, 0x7F7FEFFF, 0x7F7FF000, 0x7F7FFFFF,  # near overflow
    0xFF7FF000, 0xFF7FFFFF, 0x7F800000, 0xFF800000,  # to -inf; +-inf
]


def test_round_tf32_is_bitwise_cvt_rna():
    rng = np.random.default_rng(0)
    finite = rng.integers(0, 0x7F800000, 2000, dtype=np.uint32)
    finite |= (rng.integers(0, 2, 2000, dtype=np.uint32) << 31)
    bits = np.concatenate([np.array(_EDGE_BITS, np.uint32), finite])
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = round_tf32(x).numpy().view(np.uint32)
    want = np.array([_cvt_rna_scalar(int(u)) for u in bits], np.uint32)
    bad = np.nonzero(got != want)[0]
    assert not len(bad), [(hex(bits[i]), hex(got[i]), hex(want[i]))
                          for i in bad[:5]]
    nan = torch.tensor([float("nan")])
    assert bool(torch.isnan(round_tf32(nan)).all())


def test_split_tf32_is_two_tf32_values_summing_to_x():
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(4096)
                          * 10.0 ** np.arange(-3, 5).repeat(512)).astype(
                              np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):  # the 13 low mantissa bits are zero
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert torch.equal(round_tf32(x - hi), lo)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
