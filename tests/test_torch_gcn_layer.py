"""PyTorch port: the fused dense masked GCN layers (kernels 2.1 and 2.2).

On the CPU the wrappers run the kernels' plain PyTorch versions; those are
held here against the JAX package's Pallas layers in interpret mode, on
shapes that are none of the TPU's tile multiples.  The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bikg_graph_explainability_public_tpu.ops import pallas_gcn as jpg
from bikg_graph_explainability_public_tpu_torch.ops import gcn_layer_cuda as tpg

#: kernel 2.1: the bf16 roundings of identical float32 products are
#: identical, and the bf16 products are exact in float32, so only the
#: summation order differs
TOL_SHARED = dict(rtol=1e-5, atol=1e-5)
#: kernel 2.2: ``h @ W`` in float32 may differ in its last bit between the
#: two sides, and then its bf16 rounding may differ by one bf16 ulp (2^-8)
TOL_BATCHED = dict(rtol=1e-2, atol=1e-2)


def _inputs(n, b, c, seed, c_in=None):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.1).astype(np.float32) * rng.integers(1, 3, (n, n))
    s = rng.random((b, n)).astype(np.float32)
    s[:, rng.random(n) < 0.2] = 0.0  # masked nodes
    self_w = rng.random((b, n)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    xw = rng.standard_normal((n, c)).astype(np.float32)
    h = rng.standard_normal((b, n, c_in)).astype(np.float32) if c_in else None
    w_t = rng.standard_normal((c_in, c)).astype(np.float32) if c_in else None
    return adj, s, self_w, bias, xw, h, w_t


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("n,b,c", [(100, 5, 16), (136, 3, 128), (64, 1, 16)])
def test_shared_layer_matches_jax_interpret(n, b, c, with_bias, relu):
    adj, s, self_w, bias, xw, _, _ = _inputs(n, b, c, seed=n + b)
    jb = bias if with_bias else np.zeros(c, np.float32)
    want = np.asarray(jpg.masked_gcn_layer(
        jnp.asarray(adj, jnp.bfloat16), jnp.asarray(xw), jnp.asarray(s),
        jnp.asarray(self_w), jnp.asarray(jb), apply_relu=relu,
    ))
    got = tpg.masked_gcn_layer(
        _t(adj).to(torch.bfloat16), _t(xw), _t(s), _t(self_w),
        _t(bias) if with_bias else None, apply_relu=relu,
    )
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    np.testing.assert_allclose(got.numpy(), want, **TOL_SHARED)
    if not relu:
        assert (got < 0).any()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("n,b,c_in,c", [(100, 5, 16, 16), (136, 3, 128, 128), (64, 1, 8, 16)])
def test_batched_layer_matches_jax_interpret(n, b, c_in, c, with_bias, relu):
    adj, s, self_w, bias, _, h, w_t = _inputs(n, b, c, seed=n * b, c_in=c_in)
    jb = bias if with_bias else np.zeros(c, np.float32)
    want = np.asarray(jpg.masked_gcn_layer_batched(
        jnp.asarray(adj, jnp.bfloat16), jnp.asarray(h), jnp.asarray(w_t),
        jnp.asarray(s), jnp.asarray(self_w), jnp.asarray(jb), apply_relu=relu,
    ))
    got = tpg.masked_gcn_layer_batched(
        _t(adj).to(torch.bfloat16), _t(h), _t(w_t), _t(s), _t(self_w),
        _t(bias) if with_bias else None, apply_relu=relu,
    )
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    np.testing.assert_allclose(got.numpy(), want, **TOL_BATCHED)


def test_batched_layer_with_shared_rows_equals_shared_layer():
    """Per-sample operands that are all ``XW`` give the shared layer:
    ``h_b = X`` and ``W`` with ``X @ W = XW`` exactly (W the identity)."""
    adj, s, self_w, bias, xw, _, _ = _inputs(72, 4, 16, seed=9)
    a16 = _t(adj).to(torch.bfloat16)
    shared = tpg.masked_gcn_layer(a16, _t(xw), _t(s), _t(self_w), _t(bias))
    h = _t(np.broadcast_to(xw, (4, 72, 16)).copy())
    batched = tpg.masked_gcn_layer_batched(a16, h, torch.eye(16), _t(s), _t(self_w), _t(bias))
    torch.testing.assert_close(batched, shared, rtol=0, atol=0)


def test_wrappers_check_inputs():
    adj, s, self_w, bias, xw, h, w_t = _inputs(40, 2, 16, seed=1, c_in=8)
    a16 = _t(adj).to(torch.bfloat16)
    with pytest.raises(ValueError):  # float32 adjacency: the kernel takes bf16
        tpg.masked_gcn_layer(_t(adj), _t(xw), _t(s), _t(self_w), _t(bias))
    with pytest.raises(ValueError):  # operand rows differ from N
        tpg.masked_gcn_layer(a16, _t(xw[:30]), _t(s), _t(self_w), _t(bias))
    with pytest.raises(ValueError):  # self_w of another shape than s
        tpg.masked_gcn_layer(a16, _t(xw), _t(s), _t(self_w[:1]), _t(bias))
    with pytest.raises(ValueError):  # bias of the wrong width
        tpg.masked_gcn_layer(a16, _t(xw), _t(s), _t(self_w), _t(bias[:4]))
    with pytest.raises(ValueError):  # w_t rows differ from C_in
        tpg.masked_gcn_layer_batched(a16, _t(h), _t(w_t[:4]), _t(s), _t(self_w), _t(bias))
    with pytest.raises(ValueError):  # h of another batch than s
        tpg.masked_gcn_layer_batched(a16, _t(h[:1]), _t(w_t), _t(s), _t(self_w), _t(bias))
    with pytest.raises(ValueError):  # neither the CPU nor one device
        tpg.masked_gcn_layer(a16, _t(xw).to("meta"), _t(s), _t(self_w), _t(bias))


def test_cpu_tensors_never_build_or_launch_the_kernels():
    adj, s, self_w, bias, xw, h, w_t = _inputs(40, 2, 16, seed=2, c_in=8)
    a16 = _t(adj).to(torch.bfloat16)
    kernels = (tpg.MASKED_GCN_LAYER, tpg.OPERAND, tpg.MASKED_GCN_LAYER_BATCHED, tpg.TRANSFORM)
    before = [k.launches for k in kernels]
    tpg.masked_gcn_layer(a16, _t(xw), _t(s), _t(self_w), _t(bias))
    tpg.masked_gcn_layer_batched(a16, _t(h), _t(w_t), _t(s), _t(self_w), _t(bias))
    assert [k.launches for k in kernels] == before
    assert not tpg.MASKED_GCN_LAYER.library.built


# ---------------------------------------------------------------------------
# the card's layouts: the scaled operand S^T and the padded adjacency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,b,c", [(100, 5, 16), (136, 3, 128), (37, 2, 16), (130, 1, 16), (64, 1, 16)])
def test_scaled_operand_matches_jax_scratch_and_layer(n, b, c):
    """``S^T`` holds the JAX kernel's scratch ``(s_t[:, None] * xw).astype(
    bfloat16)`` (pallas_gcn.py:87) bit for bit, transposed; the layer built
    from it matches the Pallas layer in interpret mode."""
    adj, s, self_w, bias, xw, _, _ = _inputs(n, b, c, seed=3 * n + b)
    st = tpg.scaled_operand(_t(s), _t(xw))
    ld = tpg.operand_stride(n)
    assert st.dtype == torch.bfloat16 and st.shape == (b * c, ld) and ld % 8 == 0
    assert st.is_contiguous()  # the kernel reads it with row stride ld
    assert not st[:, n:].float().any()
    scratch = np.concatenate(
        [np.asarray((jnp.asarray(s)[t, :][:, None] * jnp.asarray(xw)).astype(jnp.bfloat16))
         for t in range(b)], axis=1,
    )  # [N, B*C], the TPU kernel's layout
    got = st[:, :n].t().float().numpy()
    np.testing.assert_array_equal(got, scratch.astype(np.float32))
    a16 = _t(adj).to(torch.bfloat16)
    agg = tpg.aggregate_operand_plain(tpg.pad_adjacency(a16), st, b)
    layer = tpg._epilogue(agg, _t(s), _t(self_w), _t(xw)[None], _t(bias), True)
    want = np.asarray(jpg.masked_gcn_layer(
        jnp.asarray(adj, jnp.bfloat16), jnp.asarray(xw), jnp.asarray(s),
        jnp.asarray(self_w), jnp.asarray(bias), apply_relu=True,
    ))
    np.testing.assert_allclose(layer.numpy(), want, **TOL_SHARED)


@pytest.mark.parametrize("n,b,c_in,c", [(100, 5, 16, 16), (37, 2, 8, 16), (130, 1, 16, 16)])
def test_batched_operand_layout_matches_jax_layer(n, b, c_in, c):
    """2.2's operand ``S^T`` of ``h_b @ W``, through the padded adjacency,
    gives the Pallas batched layer (interpret mode) at 2.2's tolerance."""
    adj, s, self_w, bias, _, h, w_t = _inputs(n, b, c, seed=5 * n + b, c_in=c_in)
    hw = torch.matmul(_t(h), _t(w_t))
    st = tpg.scaled_operand_plain(_t(s), hw)
    assert st.shape == (b * c, tpg.operand_stride(n))
    agg = tpg.aggregate_operand_plain(tpg.pad_adjacency(_t(adj).to(torch.bfloat16)), st, b)
    layer = tpg._epilogue(agg, _t(s), _t(self_w), hw, _t(bias), True)
    want = np.asarray(jpg.masked_gcn_layer_batched(
        jnp.asarray(adj, jnp.bfloat16), jnp.asarray(h), jnp.asarray(w_t),
        jnp.asarray(s), jnp.asarray(self_w), jnp.asarray(bias), apply_relu=True,
    ))
    np.testing.assert_allclose(layer.numpy(), want, **TOL_BATCHED)


@pytest.mark.parametrize("n", [37, 130, 300, 1000, 64, 136])
def test_padded_adjacency_path_equals_unpadded_bit_for_bit(n):
    """The wrapper's padding of ``A`` to a row stride of ``N`` rounded up to
    8 changes nothing: on inputs whose sums are exact in float32 the padded
    plain path equals the unpadded one bit for bit."""
    rng = np.random.default_rng(n)
    b, c = 3, 16
    adj = ((rng.random((n, n)) < 0.1) * rng.integers(1, 3, (n, n))).astype(np.float32)
    s = (rng.integers(0, 9, (b, n)) / 8.0).astype(np.float32)
    xw = rng.integers(-4, 5, (n, c)).astype(np.float32)
    a16 = _t(adj).to(torch.bfloat16)
    padded = tpg.pad_adjacency(a16)
    ld = tpg.operand_stride(n)
    assert padded.shape == (n, ld) and padded.is_contiguous()
    assert (padded is a16) == (n % 8 == 0)
    assert torch.equal(padded[:, :n], a16) and not padded[:, n:].float().any()
    got = tpg.aggregate_operand_plain(padded, tpg.scaled_operand_plain(_t(s), _t(xw)), b)
    want = tpg._aggregate_plain(a16, _t(s), _t(xw)[None])
    assert torch.equal(got, want)


def _refused_operand_inputs():
    rng = np.random.default_rng(4)
    s = _t(rng.random((3, 40)).astype(np.float32))
    xw = _t(rng.standard_normal((40, 16)).astype(np.float32))
    return {
        "s not contiguous": (_t(rng.random((40, 3)).astype(np.float32)).t(), xw),
        "xw not contiguous": (s, xw.t().contiguous().t()),
        "xw float64": (s, xw.double()),
        "s bfloat16": (s.to(torch.bfloat16), xw),
        "xw rows differ from N": (s, xw[:30].contiguous()),
        "xw per-sample": (s, xw[None].expand(3, 40, 16).contiguous()),
        "xw on another device": (s, xw.to("meta")),
    }


@pytest.mark.parametrize("case", list(_refused_operand_inputs()))
def test_scaled_operand_refuses_bad_inputs(case):
    s, xw = _refused_operand_inputs()[case]
    before = tpg.OPERAND.launches
    with pytest.raises(ValueError):
        tpg.scaled_operand(s, xw)
    assert tpg.OPERAND.launches == before


def _breakdown_script():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "dense_layer_breakdown", os.path.join(root, "scripts", "dense_layer_breakdown.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["kernel", "no epilogue", "epilogue without its loads",
                                     "epilogue without its stores",
                                     "loads only (no products, no epilogue)"])
def test_breakdown_variants_find_their_anchors_in_the_kernel(variant):
    """``scripts/dense_layer_breakdown.py`` cuts parts out of the kernel's
    source by text: each cut must find its anchor exactly once."""
    import os

    mod = _breakdown_script()
    src_path = os.path.join(os.path.dirname(tpg.__file__), "csrc", "masked_gcn_layer.cu")
    with open(src_path) as f:
        src = f.read()
    for old, new in mod.VARIANTS[variant]:
        assert src.count(old) == 1 and old != new
