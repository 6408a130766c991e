"""The port's flash attention (plain versions, autograd function, dispatcher)
against the JAX package's Pallas kernels, run in interpret mode on the CPU as
``tests/unit/test_flash_attention.py`` runs them (S <= 128, blocks of 32).

The same numpy inputs from a seed go through both packages, in fp32.
Tolerances: 2e-5 on the forward (o and lse) and 5e-5 on the backward, the
bounds the JAX package's own flash tests use against its XLA reference:
the two sides sum in different orders and block sizes (Pallas 32 x 32
tiles with an online softmax, the plain versions one dense softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import xla_attention
from deepspeed_tpu.ops.pallas.flash_attention import (
    _flash_bwd_pallas,
    _flash_fwd,
    _supported,
    flash_attention as jax_flash_attention,
)
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
from torch_serving_common import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
BWD_TOL = 5e-5
BLOCK = 32


def _inputs(b=2, sq=64, skv=64, hq=4, hkv=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    return q, k, v, do


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [dict(hq=4, hkv=4), dict(hq=4, hkv=2),
                                   dict(hq=8, hkv=2, sq=128, skv=128, b=1),
                                   dict(hq=4, hkv=2, d=16), dict(hq=4, hkv=2, d=80)],
                         ids=["mha", "gqa2", "gqa4_s128", "gqa2_d16", "gqa2_d80"])
def test_plain_versions_match_pallas(causal, shape):
    q, k, v, do = _inputs(**shape)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jo, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
                          BLOCK, BLOCK)
    jdq, jdk, jdv = _flash_bwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jlse,
                                      jnp.asarray(do), scale, causal, BLOCK, BLOCK)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = fa.flash_attention_fwd_ref(tq, tk, tv, causal)
    _close(o, jo, FWD_TOL)
    _close(lse, jlse, FWD_TOL)
    # the backward from the JAX side's own o and lse, so only the backward differs
    dq, dk, dv = fa.flash_attention_bwd_ref(tq, tk, tv, torch.from_numpy(np.array(jo)),
                                            torch.from_numpy(np.array(jlse)), tdo, causal)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got, want, BWD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_autograd_function_matches_jax_grad(causal):
    q, k, v, do = _inputs(sq=64, skv=64, hq=4, hkv=2)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, None, BLOCK, BLOCK) * do)

    want_o = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                 None, BLOCK, BLOCK)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    fa.reset_counts()
    o = fa.flash_attention(tq, tk, tv, causal)
    (o * torch.from_numpy(do)).sum().backward()
    _close(o, want_o, FWD_TOL)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, BWD_TOL)
    # CPU tensors take the plain versions; no kernel is launched
    assert fa.flash_attention_fwd_ref.calls == 1
    assert fa.flash_attention_fwd.launches == 0
    assert fa.flash_attention_dkdv.launches == fa.flash_attention_dq.launches == 0


def test_causal_unequal_lengths_follow_pallas():
    """Causal with Sq != Skv: the Pallas kernel masks q_pos >= k_pos from 0
    on both sides (top-left); xla_attention aligns the queries with the end
    of the keys. The port's flash path follows Pallas, its eager oracle XLA."""
    q, k, v, do = _inputs(sq=64, skv=128, hq=4, hkv=2)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jo, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True,
                          BLOCK, BLOCK)
    jdq, jdk, jdv = _flash_bwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jlse,
                                      jnp.asarray(do), scale, True, BLOCK, BLOCK)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = fa.flash_attention_fwd_ref(tq, tk, tv, True)
    _close(o, jo, FWD_TOL)
    _close(lse, jlse, FWD_TOL)
    grads = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, True)
    for got, want in zip(grads, (jdq, jdk, jdv)):
        _close(got, want, BWD_TOL)
    # keys past the last query's position get no gradient (top-left mask)
    assert not grads[1][:, 64:].any() and not grads[2][:, 64:].any()
    # the two reference paths really do disagree here
    xla = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    assert np.abs(np.asarray(xla) - np.asarray(jo)).max() > 0.1
    _close(tattn.eager_attention(tq, tk, tv, causal=True), xla, FWD_TOL)


@pytest.mark.parametrize("case", ["causal", "full", "bias", "suffix"])
def test_eager_attention_matches_xla(case):
    sq = 32 if case == "suffix" else 64
    q, k, v, _ = _inputs(sq=sq, skv=64, hq=4, hkv=2)
    bias = None
    if case == "bias":
        bias = np.random.default_rng(5).normal(size=(2, 4, sq, 64)).astype(np.float32)
    causal = case != "full"
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                         bias=None if bias is None else jnp.asarray(bias))
    got = tattn.eager_attention(*_t(q, k, v), causal=causal,
                                bias=None if bias is None else torch.from_numpy(bias))
    _close(got, want, FWD_TOL)


def test_eager_attention_rounds_weights_to_v_dtype():
    """xla_attention casts the softmax weights to v's dtype before P @ V
    (the flash kernels keep them in fp32); the port's eager oracle does the
    same, so in bf16 it agrees with XLA within bf16 rounding (2e-2)."""
    q, k, v, _ = _inputs(hq=4, hkv=2)
    bq, bk, bv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    want = xla_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16))
    got = tattn.eager_attention(bq, bk, bv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_attention_dispatch():
    q, k, v, _ = _inputs()
    tq, tk, tv = _t(q, k, v)
    fa.reset_counts()
    auto = tattn.attention(tq, tk, tv)
    assert fa.flash_attention_fwd_ref.calls == 1
    plain = tattn.attention(tq, tk, tv, impl="plain")
    bias = torch.zeros(2, 4, 64, 64)
    biased = tattn.attention(tq, tk, tv, bias=bias)
    assert fa.flash_attention_fwd_ref.calls == 1  # bias and "plain" take eager_attention
    _close(auto, plain.numpy(), FWD_TOL)
    _close(biased, plain.numpy(), FWD_TOL)
    with pytest.raises(ValueError):
        tattn.attention(tq, tk, tv, impl="pallas")


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Shape, dtype and layout checks run before any launch; on the CPU they
    are reached through a tensor on the 'meta' device, which no wrapper
    computes on."""
    q, k, v, _ = _inputs(d=12)
    tq, tk, tv = (x.to("meta") for x in _t(q, k, v))
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(tq, tk, tv)
    with pytest.raises(ValueError, match="head dims"):
        fa._check(tq, tk, tv)
    for d in (1032, 4096):  # no upper limit: above 1024 the rows go to a workspace
        fa._check(*(torch.empty(1, 8, 2, d, device="meta") for _ in range(3)))
    q, k, v, _ = _inputs(d=64)
    tq, tk, tv = _t(q, k, v)
    with pytest.raises(TypeError):
        fa._check(tq.double(), tk, tv)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(tq.transpose(1, 3).contiguous().transpose(1, 3), tk, tv)


# ------------------------------------------------ tensor maps (bf16 dK/dV)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_tma_layout_of_a_contiguous_tensor(dtype):
    """dims innermost first (D, S, H, B), then the byte strides of S, H, B."""
    x = torch.zeros(2, 100, 8, 128, dtype=dtype)
    es = x.element_size()
    assert fa.tma_layout(x) == [128, 100, 8, 2, 8 * 128 * es, 128 * es, 100 * 8 * 128 * es]


def test_tma_layout_of_a_strided_view():
    """A [B, H, S, D] buffer viewed as [B, S, H, D], as the kernels read it."""
    x = torch.zeros(2, 8, 100, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert fa.tma_layout(x) == [64, 100, 8, 2, 64 * 2, 100 * 64 * 2, 8 * 100 * 64 * 2]


def test_tma_layout_rejects_what_tma_cannot_read():
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.tma_layout(torch.zeros(1, 4, 1, 4, dtype=torch.bfloat16))  # 8-byte rows
    with pytest.raises(ValueError, match="contiguous"):
        fa.tma_layout(torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16).transpose(2, 3))


def test_kernel_layouts_give_the_bf16_kernels_one_map_per_tensor():
    """The bf16 wgmma kernels get the tensor maps of their inputs in turn (q,
    k, v for the forward; q, k, v, dO for dK/dV and dQ), 7 values each; the
    CUDA-core kernels (fp32, and bf16 at head dims other than 64 and 128),
    which read through strides, get none."""
    q = torch.zeros(2, 130, 8, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 8, 100, 128, dtype=torch.bfloat16).transpose(1, 2)  # strided
    layouts = fa.kernel_layouts(q, k, k, q)
    assert list(layouts) == fa.tma_layout(q) + 2 * fa.tma_layout(k) + fa.tma_layout(q)
    assert fa.kernel_layouts(q.float(), k.float(), k.float()) is None
    q80 = torch.zeros(2, 130, 8, 80, dtype=torch.bfloat16)
    assert fa.kernel_layouts(q80, q80, q80) is None
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.kernel_layouts(q, torch.zeros(1, 4, 1, 4, dtype=torch.bfloat16))


# ------------------------------------------------------------ head dims
@pytest.mark.parametrize("module", [fa, pa], ids=["flash", "paged"])
def test_supports_takes_the_reference_head_dims(module):
    """The kernels take every head dim the reference's Pallas kernels take
    (``_supported``: ``d % 8 == 0``), here from 1 to 4096 (above 256 on the
    wide kernels, above 1024 with their rows in a workspace), in fp32 and
    bf16; off the 8-grid they refuse."""
    class Shape:  # _supported reads shapes only: [B, S, H, D]
        def __init__(self, *shape):
            self.shape = shape

    for d in range(1, 4097):
        want = _supported(Shape(1, 64, 4, d), Shape(1, 64, 2, d), BLOCK, BLOCK)
        assert want == (d % 8 == 0)
        for dtype in (torch.float32, torch.bfloat16):
            assert module.supports(d, dtype) == want, (d, dtype)
    assert not module.supports(64, torch.float16)


def test_wide_workspace_holds_the_rows_above_1024():
    """Up to 1024 the wide kernels keep a CTA's row vectors in shared memory
    and take no workspace; above it, ``vectors`` fp32 [8][d] arrays for
    each CTA."""
    assert fa.wide_workspace("cpu", 1024, 4, 10) is None
    for d, vectors, ctas in ((1032, 2, 7), (2048, 4, 3), (4096, 3, 1)):
        ws = fa.wide_workspace("cpu", d, vectors, ctas)
        assert ws.dtype == torch.float32 and ws.numel() == ctas * vectors * 8 * d
