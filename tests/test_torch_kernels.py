"""Parity of the PyTorch port's kernel modules with the JAX package, on
the CPU.

The same numpy inputs (from a seed) go through the JAX function and its
``paddle_tpu_torch`` counterpart.  On the CPU the port's wrappers run
their plain PyTorch versions; the CUDA kernels themselves are held
against those on the card by ``chip_smoke.py``.

Tolerances:
 - paged attention (fp32 and int8 pages): atol = rtol = 2e-5, the JAX
   package's own tolerance between its interpret-mode kernel and its
   reference (only the order of the f32 sums differs);
 - w8a16: atol 1e-5 against ``w8a16_matmul_reference`` (an f32 product
   of the same int8 values; the interpret-mode kernel is not the oracle,
   its own bit-identity test fails on this tree);
 - quantizers: identical bytes and scales;
 - LayerNorm (y, dx, dw, db) against the interpret-mode Pallas kernel and
   its ``jax.vjp``: 1e-5 in f32 (the sums run in another order), 2e-2
   absolute and relative in bf16 (one bf16 rounding of the outputs).
   With a residual (y, dx, dr, dw, db) the same, against the
   interpret-mode kernel in both dtypes: it adds the residual in f32 as
   the port does, where the JAX package's XLA ``F.layer_norm`` adds it in
   x's dtype first.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as pt
from paddle_tpu.ops import fused_kernels as jfk
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import quant_kernels as jqk
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.nn.functional import norm as tnorm
from paddle_tpu_torch.ops import fused_kernels as tfk
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import quant_kernels as tqk

B, H, D, PS, MAXP = 3, 2, 8, 4, 5
# row 0 has one live slot, row 1 a partly filled second page, row 2 a
# full fifth page; every row's table has dead pages past its length
LENGTHS = np.array([1, 7, 20], np.int32)


def _paged_inputs(seed):
    rng = np.random.RandomState(seed)
    pages = 1 + B * MAXP
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(pages, PS, H, D).astype(np.float32)
    v = rng.randn(pages, PS, H, D).astype(np.float32)
    tables = rng.permutation(np.arange(1, pages))[:B * MAXP] \
        .reshape(B, MAXP).astype(np.int32)
    return q, k, v, tables


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("seed", [1, 2])
def test_paged_attention_matches_jax(seed):
    q, k, v, tables = _paged_inputs(seed)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, LENGTHS)]
    kernel = jpa.paged_attention(*jargs, use_pallas=True, interpret=True)
    ref = jpa.paged_attention_reference(*jargs)
    out = tpa.paged_attention(*_t(q, k, v, tables, LENGTHS))
    assert out.dtype == torch.float32 and out.shape == (B, H, D)
    for want in (kernel, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("seed", [3, 4])
def test_paged_attention_int8_matches_jax(seed):
    q, k, v, tables = _paged_inputs(seed)
    kq, ks = (np.asarray(a) for a in jqk.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jqk.quantize_kv(jnp.asarray(v)))
    jargs = [jnp.asarray(a) for a in (q, kq, vq, ks, vs, tables, LENGTHS)]
    kernel = jpa.paged_attention_int8(*jargs, use_pallas=True,
                                      interpret=True)
    ref = jpa.paged_attention_int8_reference(*jargs)
    out = tpa.paged_attention_int8(*_t(q, kq, vq, ks, vs, tables, LENGTHS))
    for want in (kernel, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def test_paged_attention_bf16_rounds_weights_like_jax():
    q, k, v, tables = _paged_inputs(5)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jpa.paged_attention_reference(*bf, jnp.asarray(tables),
                                         jnp.asarray(LENGTHS))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tpa.paged_attention(tq, tk, tv, *_t(tables, LENGTHS))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape", [(4, 32, 64), (7, 64, 32), (2, 3, 16, 96)])
def test_w8a16_matches_jax_reference(shape):
    rng = np.random.RandomState(sum(shape))
    *lead, k, n = shape
    x = rng.randn(*lead, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    wq, sc = (np.asarray(a) for a in jqk.quantize_weight(jnp.asarray(w),
                                                         axis=1))
    want = jqk.w8a16_matmul_reference(jnp.asarray(x), jnp.asarray(wq),
                                      jnp.asarray(sc))
    out = tqk.w8a16_matmul(*_t(x, wq, sc))
    assert out.shape == tuple(lead) + (n,)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantize_weight_bytes_match_jax(axis):
    rng = np.random.RandomState(6)
    w = (rng.randn(24, 40) * 0.1).astype(np.float32)
    w[:, 3] = 0.0                      # an all-zero column
    w[5, :] = 0.0                      # and an all-zero row
    w[0, 0] = 2.5 * (np.abs(w).max())  # a clipped outlier channel
    jq, js = jqk.quantize_weight(jnp.asarray(w), axis=axis)
    tq, ts = tqk.quantize_weight(torch.from_numpy(w), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(
        tqk.dequantize_weight(tq, ts, axis=axis).numpy(),
        np.asarray(jqk.dequantize_weight(jq, js, axis=axis)), rtol=0, atol=0)


def test_quantize_kv_bytes_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 9, 2, 8).astype(np.float32)
    x[0, 0, 1] = 0.0                   # an all-zero (token, head) row
    # exact halves: round-half-to-even must agree
    x[1, 1, 0] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.25, 127.0],
                          np.float32)
    jq, js = jqk.quantize_kv(jnp.asarray(x))
    tq, ts = tqk.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tqk.dequantize_kv(tq, ts).numpy(),
                                  np.asarray(jqk.dequantize_kv(jq, js)))


# -- the dispatch rule: CPU -> plain version, CUDA -> kernel, never both --

class _FakeCuda(types.SimpleNamespace):
    """Stands in for a CUDA tensor: its device, shape, dtype and strides
    (contiguous unless given), and the few members the launchers' checks
    read before the dispatch decision."""

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self.strides is None

    def data_ptr(self):
        return 0

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def stride(self, i=None):
        st = self.strides
        if st is None:
            st = tuple(int(np.prod(self.shape[j + 1:]))
                       for j in range(len(self.shape)))
        return st if i is None else st[i]


def _cuda_like(shape, dtype=torch.bfloat16, strides=None):
    return _FakeCuda(device=torch.device("cuda", 0), shape=tuple(shape),
                     dtype=dtype, strides=strides)


def _forbid(*a, **k):
    raise AssertionError("a CUDA tensor reached the plain version")


def test_cuda_tensor_never_reaches_plain_paged_attention(monkeypatch):
    # neither plain version nor the split kernels' mirror; each call (one
    # split launch and one combine) adds exactly one to its own counter
    calls = []
    monkeypatch.setattr(tpa, "paged_attention_reference", _forbid)
    monkeypatch.setattr(tpa, "paged_attention_int8_reference", _forbid)
    monkeypatch.setattr(tpa, "paged_attention_split_reference", _forbid)
    monkeypatch.setattr(tpa, "_launch",
                        lambda *a: calls.append(a[4] is not None) or "out")
    q = _cuda_like((2, 2, 8))
    for _ in range(3):
        before = (tpa.paged_attention.launches,
                  tpa.paged_attention_int8.launches)
        assert tpa.paged_attention(q, q, q, q, q) == "out"
        assert (tpa.paged_attention.launches,
                tpa.paged_attention_int8.launches) == (before[0] + 1,
                                                       before[1])
        assert tpa.paged_attention_int8(q, q, q, q, q, q, q) == "out"
        assert (tpa.paged_attention.launches,
                tpa.paged_attention_int8.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert calls == [False, True] * 3


def test_cuda_tensor_never_reaches_plain_w8a16(monkeypatch):
    monkeypatch.setattr(tqk, "w8a16_matmul_reference", _forbid)
    seen = []
    monkeypatch.setattr(tqk, "_launch",
                        lambda x2, w, s: seen.append(x2.shape)
                        or torch.zeros(x2.shape[0], w.shape[1]))
    before = tqk.w8a16_matmul.launches
    # a tensor on any device but the CPU takes the kernel path
    x = torch.zeros(2, 3, 32, device="meta")
    out = tqk.w8a16_matmul(x, torch.zeros(32, 64, dtype=torch.int8),
                           torch.ones(64))
    assert seen == [(6, 32)] and out.shape == (2, 3, 64)
    assert tqk.w8a16_matmul.launches == before + 1


def test_cpu_tensor_takes_plain_version_without_counting(monkeypatch):
    monkeypatch.setattr(tpa, "_launch", _forbid)
    monkeypatch.setattr(tqk, "_launch", _forbid)
    before = {n: f.launches for n, f in (
        ("pa", tpa.paged_attention), ("w", tqk.w8a16_matmul))}
    q, k, v, tables = _paged_inputs(8)
    tpa.paged_attention(*_t(q, k, v, tables, LENGTHS))
    tqk.w8a16_matmul(torch.zeros(2, 32), torch.zeros(32, 32,
                                                     dtype=torch.int8),
                     torch.ones(32))
    assert tpa.paged_attention.launches == before["pa"]
    assert tqk.w8a16_matmul.launches == before["w"]


def test_kernel_launchers_refuse_non_cuda_tensors():
    meta = torch.zeros(2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        tpa._launch(meta, meta, meta, None, None, meta, meta, 1.0)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tqk._launch(torch.zeros(2, 32, device="meta"),
                    torch.zeros(32, 32, dtype=torch.int8), torch.ones(32))


def test_w8a16_bf16_activations_match_jax_reference():
    # bf16 x: widened to f32 for the product, the output rounded back to
    # bf16; the f32 sums may differ in order only, so at most one bf16
    # rounding step apart
    rng = np.random.RandomState(8)
    x = rng.randn(5, 64).astype(np.float32)
    w = (rng.randn(64, 96) * 0.05).astype(np.float32)
    wq, sc = (np.asarray(a) for a in jqk.quantize_weight(jnp.asarray(w),
                                                         axis=1))
    want = jqk.w8a16_matmul_reference(jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(wq), jnp.asarray(sc))
    xt, wt, st = _t(x, wq, sc)
    out = tqk.w8a16_matmul(xt.to(torch.bfloat16), wt, st)
    assert out.dtype == torch.bfloat16 and out.shape == (5, 96)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


# -- LayerNorm -------------------------------------------------------------

LN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
          "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _ln_inputs(rows, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, d) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.randn(d)).astype(np.float32)
    b = (0.2 * rng.randn(d)).astype(np.float32)
    g = rng.randn(rows, d).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(37, 96), (40, 128), (6, 2048), (6, 100)])
def test_layer_norm_and_grads_match_jax_kernel(rows, d, dtype):
    x, w, b, g = _ln_inputs(rows, d, d + rows)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx, jw, jb, jg = (jnp.asarray(a, jdt) for a in (x, w, b, g))
    jy, vjp = jax.vjp(lambda *a: jfk.fused_layer_norm(*a, interpret=True),
                      jx, jw, jb)
    jgrads = vjp(jg)

    tdt = getattr(torch, dtype)
    tx, tw, tb = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (x, w, b))
    ty = tfk.fused_layer_norm(tx, tw, tb, 1e-5)
    ty.backward(torch.from_numpy(g).to(tdt))
    assert ty.dtype == tdt
    for got, want in zip((ty, tx.grad, tw.grad, tb.grad), (jy, *jgrads)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   **LN_TOL[dtype])


def test_cuda_tensor_never_reaches_plain_layer_norm(monkeypatch):
    monkeypatch.setattr(tfk, "layer_norm_fwd_reference", _forbid)
    monkeypatch.setattr(tfk, "layer_norm_bwd_reference", _forbid)
    monkeypatch.setattr(tfk, "_launch_fwd",
                        lambda x, w, b, eps, res: ("y", "mean", "rstd"))
    monkeypatch.setattr(tfk, "_launch_bwd",
                        lambda g, x, w, m, rs, res: ("dx", "dw", "db"))
    fwd, bwd = tfk.layer_norm_fwd, tfk.layer_norm_bwd
    before = (fwd.launches, bwd.launches, fwd.residual_launches,
              bwd.residual_launches)
    x = _cuda_like((4, 8))
    assert tfk.layer_norm_fwd(x, x, x) == ("y", "mean", "rstd")
    assert tfk.layer_norm_bwd(x, x, x, x, x) == ("dx", "dw", "db")
    assert tfk.layer_norm_fwd(x, x, x, 1e-5, x) == ("y", "mean", "rstd")
    assert tfk.layer_norm_bwd(x, x, x, x, x, x) == ("dx", "dw", "db")
    assert (fwd.launches, bwd.launches, fwd.residual_launches,
            bwd.residual_launches) == (before[0] + 2, before[1] + 2,
                                       before[2] + 1, before[3] + 1)


def test_cpu_layer_norm_takes_plain_version_without_counting(monkeypatch):
    monkeypatch.setattr(tfk, "_launch_fwd", _forbid)
    monkeypatch.setattr(tfk, "_launch_bwd", _forbid)
    before = (tfk.layer_norm_fwd.launches, tfk.layer_norm_bwd.launches)
    x, w, b, g = _t(*_ln_inputs(5, 16, 0))
    x.requires_grad_()
    tfk.fused_layer_norm(x, w, b).backward(g)
    assert x.grad is not None
    assert (tfk.layer_norm_fwd.launches,
            tfk.layer_norm_bwd.launches) == before


def test_layer_norm_launchers_refuse_what_the_kernel_does_not_take():
    meta = torch.zeros(4, 16, device="meta")
    vec = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfk._launch_fwd(meta, vec, vec, 1e-5)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfk._launch_bwd(meta, meta, vec, vec, vec)
    with pytest.raises(ValueError, match="2-D"):
        tfk.fused_layer_norm(torch.zeros(2, 3, 4), torch.ones(4),
                             torch.zeros(4))


def test_layer_norm_launchers_refuse_a_residual_the_kernel_does_not_take():
    x, w = _cuda_like((4, 16)), _cuda_like((16,))
    tfk._check(x, w, w, residual=_cuda_like((4, 16)))   # what it takes
    with pytest.raises(ValueError, match="x's shape"):
        tfk._check(x, w, w, residual=_cuda_like((4, 8)))
    with pytest.raises(ValueError, match="does not match x"):
        tfk._check(x, w, w, residual=_cuda_like((4, 16), torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(37, 96), (40, 128), (6, 2048), (6, 100)])
def test_residual_layer_norm_and_grads_match_jax_kernel(rows, d, dtype):
    x, w, b, g = _ln_inputs(rows, d, d + rows + 1)
    r = np.random.RandomState(rows).randn(rows, d).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx, jw, jb, jr, jg = (jnp.asarray(a, jdt) for a in (x, w, b, r, g))
    jy, vjp = jax.vjp(lambda xx, ww, bb, rr: jfk.fused_layer_norm(
        xx, ww, bb, residual=rr, interpret=True), jx, jw, jb, jr)
    jgrads = vjp(jg)

    tdt = getattr(torch, dtype)
    tx, tw, tb, tr = (torch.from_numpy(a).to(tdt).requires_grad_()
                      for a in (x, w, b, r))
    ty = tfk.fused_layer_norm(tx, tw, tb, 1e-5, residual=tr)
    ty.backward(torch.from_numpy(g).to(tdt))
    for got, want in zip((ty, tx.grad, tw.grad, tb.grad, tr.grad),
                         (jy, *jgrads)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   **LN_TOL[dtype])
    # the residual's gradient is dx itself when the dtypes agree
    assert torch.equal(tx.grad, tr.grad)


def test_residual_layer_norm_matches_jax_functional_in_f32():
    # in f32 the JAX package's XLA F.layer_norm (its CPU path) adds the
    # residual exactly as the kernel does, so it is an oracle too
    x, w, b, _ = _ln_inputs(12, 64, 5)
    r = np.random.RandomState(6).randn(12, 64).astype(np.float32)
    want = pt.nn.functional.layer_norm(
        Tensor(jnp.asarray(x)), 64, Tensor(jnp.asarray(w)),
        Tensor(jnp.asarray(b)), 1e-5, residual=Tensor(jnp.asarray(r)))
    got = tnorm.layer_norm(*_t(x), 64, *_t(w, b), 1e-5, residual=_t(r)[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **LN_TOL[
        "float32"])


# -- LayerNorm without weight and bias, and the block kernels' dispatch -----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", ["none", "weight", "bias"])
def test_no_affine_layer_norm_and_grads_match_jax_kernel(dtype, affine):
    # the variant the fusion pass's matches reach (weight and/or bias None)
    x, w, b, g = _ln_inputs(37, 96, 11)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    w = w if affine == "weight" else None
    b = b if affine == "bias" else None
    jargs = [jnp.asarray(a, jdt) for a in (x, w, b) if a is not None]

    def jfn(xx, *rest):
        it = iter(rest)
        return jfk.fused_layer_norm(xx, next(it) if w is not None else None,
                                    next(it) if b is not None else None,
                                    interpret=True)

    jy, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(g, jdt))
    targs = [torch.from_numpy(a).to(tdt).requires_grad_()
             for a in (x, w, b) if a is not None]
    it = iter(targs[1:])
    ty = tfk.fused_layer_norm(targs[0], next(it) if w is not None else None,
                              next(it) if b is not None else None, 1e-5)
    ty.backward(torch.from_numpy(g).to(tdt))
    for got, want in zip((ty, *(t.grad for t in targs)), (jy, *jgrads)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   **LN_TOL[dtype])


def test_no_affine_layer_norm_functional_and_check():
    x, _, _, _ = _ln_inputs(6, 32, 3)
    got = tnorm.layer_norm(_t(x)[0], 32, None, None)
    want = tfk.layer_norm_fwd_reference(_t(x)[0], torch.ones(32),
                                        torch.zeros(32))[0]
    assert torch.equal(got, want)
    xc = _cuda_like((4, 16))
    assert tfk._check(xc, None, None)[1:] == (4, 16)


def test_cuda_tensor_never_reaches_plain_block_kernels(monkeypatch):
    monkeypatch.setattr(tfk, "ln_matmul_reference", _forbid)
    monkeypatch.setattr(tfk, "matmul_bias_gelu_reference", _forbid)
    monkeypatch.setattr(tfk, "_launch_ln_matmul", lambda *a: "y")
    monkeypatch.setattr(tfk, "_launch_matmul_bias_gelu",
                        lambda *a: ("y", "z"))
    before = (tfk.ln_matmul.launches, tfk.matmul_bias_gelu.launches)
    x = _cuda_like((4, 16))
    assert tfk.ln_matmul(x, x) == "y"
    assert tfk.matmul_bias_gelu(x, x) == ("y", "z")
    assert (tfk.ln_matmul.launches, tfk.matmul_bias_gelu.launches) == (
        before[0] + 1, before[1] + 1)


def test_cpu_block_kernels_take_plain_versions_without_counting(monkeypatch):
    monkeypatch.setattr(tfk, "_launch_ln_matmul", _forbid)
    monkeypatch.setattr(tfk, "_launch_matmul_bias_gelu", _forbid)
    before = (tfk.ln_matmul.launches, tfk.matmul_bias_gelu.launches)
    x, w = torch.randn(5, 16, requires_grad=True), torch.randn(16, 24)
    (tfk.fused_ln_matmul(x, w).sum()
     + tfk.fused_matmul_bias_gelu(x, w).sum()).backward()
    assert x.grad is not None
    assert (tfk.ln_matmul.launches, tfk.matmul_bias_gelu.launches) == before


def test_block_kernel_checks_take_what_the_kernels_take():
    x, vec = _cuda_like((64, 96)), _cuda_like((200,))
    # a Linear weight (k, n), n contiguous, and a table's transposed view
    assert tfk._check_gemm(x, _cuda_like((96, 200)), vec,
                           kernel="t") == (64, 96, 200, 200, 1)
    view = _cuda_like((96, 200), strides=(1, 96))
    assert tfk._check_gemm(x, view, vec, kernel="t") == (64, 96, 200, 1, 96)
    assert tfk._check_gemm(x, view, None, _cuda_like((96,)), None,
                           _cuda_like((64, 96)),
                           kernel="t")[:3] == (64, 96, 200)


@pytest.mark.parametrize("case,match", [
    ("meta", "not a CUDA device"),
    ("dtype", "does not match x"),
    ("k", "multiple of 8"),
    ("n", "multiple of 8"),
    ("rows", "out of range"),
    ("strides", "unit stride"),
    ("shape", "does not take"),
    ("bias", r"bias must be \(200,\)"),
    ("x_view", "contiguous"),
])
def test_block_kernel_checks_raise_on_what_the_kernels_do_not_take(case,
                                                                    match):
    x, w, b = _cuda_like((64, 96)), _cuda_like((96, 200)), _cuda_like((200,))
    if case == "meta":
        x = torch.zeros(64, 96, device="meta")
    elif case == "dtype":
        b = _cuda_like((200,), torch.float32)
    elif case == "k":
        x, w = _cuda_like((64, 92)), _cuda_like((92, 200))
    elif case == "n":
        # a Linear weight whose rows are not 16 bytes apart: the wrappers
        # pass a zero-padded copy of it, never the weight itself
        w, b = _cuda_like((96, 196)), _cuda_like((196,))
    elif case == "rows":
        x = _cuda_like((2 ** 31, 96))
    elif case == "strides":
        w = _cuda_like((96, 200), strides=(400, 2))
    elif case == "shape":
        w = _cuda_like((64, 200))
    elif case == "bias":
        b = _cuda_like((100,))
    elif case == "x_view":
        x = _cuda_like((64, 96), strides=(192, 1))
    with pytest.raises(ValueError, match=match):
        tfk._check_gemm(x, w, b, kernel="t")
