"""Parity of the PyTorch port's softmax cross-entropy with the JAX
package, on the CPU.

The same numpy inputs (from a seed) go through the JAX function and its
``paddle_tpu_torch`` counterpart.  On the CPU the port's wrappers run
their plain PyTorch versions; the CUDA kernels of
``csrc/softmax_xent.cu`` are held against those on the card by
``chip_smoke.py``.

Tolerances:
 - ``fused_softmax_xent`` loss and dlogits against the JAX package's
   interpret-mode Pallas kernel (``fused_softmax_xent(...,
   interpret=True)`` and its ``jax.vjp``) and the loss against its plain
   ``softmax_xent_reference``: 1e-5 absolute and relative (the same f32
   arithmetic, summed in another order).  With bf16 logits the loss (f32)
   and dlogits (bf16, one rounding of the same f32 value) are held to the
   same 1e-5;
 - the port's ``F.cross_entropy`` against the JAX package's (its XLA path
   on the CPU): loss and the gradient of its sum within 1e-5, for every
   reduction, both label layouts, ignored labels, smoothing, soft labels
   and class weights.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.ops import fused_kernels as jfk
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import loss as tloss
from paddle_tpu_torch.ops import fused_kernels as tfk

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(rows, v, seed, ignore_index=-100):
    """Logits around 0 with a few large ones, labels with ignored rows
    and one label past the vocabulary (clipped to V - 1 for the target
    logit), a random output gradient."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, v) * 2).astype(np.float32)
    x[0, 0] = 9.0
    labels = rng.randint(0, v, rows).astype(np.int32)
    labels[1::4] = ignore_index
    labels[2] = v + 5
    g = rng.randn(rows).astype(np.float32)
    return x, labels, g


def _jax_xent(x, labels, g, dtype, **opts):
    jx = jnp.asarray(x, dtype)
    loss, vjp = jax.vjp(lambda a: jfk.fused_softmax_xent(
        a, jnp.asarray(labels), interpret=True, **opts), jx)
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(loss), np.asarray(dx, np.float32)


def _port_xent(x, labels, g, dtype, **opts):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    loss = tfk.fused_softmax_xent(tx, torch.from_numpy(labels).long(),
                                  **opts)
    loss.backward(torch.from_numpy(g))
    return loss, tx.grad


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("rows,v", [(37, 1000), (8, 2), (20, 384)])
def test_xent_and_grad_match_jax_kernel_and_reference(rows, v, smoothing):
    x, labels, g = _inputs(rows, v, rows + v)
    opts = dict(ignore_index=-100, label_smoothing=smoothing)
    jloss, jdx = _jax_xent(x, labels, g, jnp.float32, **opts)
    want_ref = np.asarray(jfk.softmax_xent_reference(
        jnp.asarray(x), jnp.asarray(labels), **opts))
    loss, dx = _port_xent(x, labels, g, torch.float32, **opts)
    assert loss.dtype == torch.float32 and loss.shape == (rows,)
    assert dx.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), jloss, **TOL)
    np.testing.assert_allclose(loss.detach().numpy(), want_ref, **TOL)
    np.testing.assert_allclose(dx.numpy(), jdx, **TOL)
    ignored = labels == -100
    assert (loss.detach().numpy()[ignored] == 0).all()
    assert (dx.numpy()[ignored] == 0).all()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_bf16_xent_matches_jax_kernel(smoothing):
    x, labels, g = _inputs(37, 1000, 3)
    opts = dict(ignore_index=-100, label_smoothing=smoothing)
    jloss, jdx = _jax_xent(x, labels, g, jnp.bfloat16, **opts)
    loss, dx = _port_xent(x, labels, g, torch.bfloat16, **opts)
    assert loss.dtype == torch.float32 and dx.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.detach().numpy(), jloss, **TOL)
    np.testing.assert_allclose(dx.float().numpy(), jdx, **TOL)


def test_xent_other_ignore_index_and_no_valid_row():
    x, labels, g = _inputs(6, 50, 11, ignore_index=7)
    opts = dict(ignore_index=7, label_smoothing=0.0)
    jloss, jdx = _jax_xent(x, labels, g, jnp.float32, **opts)
    loss, dx = _port_xent(x, labels, g, torch.float32, **opts)
    np.testing.assert_allclose(loss.detach().numpy(), jloss, **TOL)
    np.testing.assert_allclose(dx.numpy(), jdx, **TOL)
    none_valid = np.full(6, -100, np.int32)
    loss, dx = _port_xent(x, none_valid, g, torch.float32)
    assert not loss.detach().any() and not dx.any()


def test_plain_forward_returns_the_lse_the_backward_uses():
    x, labels, g = _inputs(9, 70, 5)
    tx, tl = torch.from_numpy(x), torch.from_numpy(labels)
    loss, lse = tfk.softmax_xent_fwd_reference(tx, tl)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.nn.logsumexp(jnp.asarray(x), axis=-1)), **TOL)
    dx = tfk.softmax_xent_bwd_reference(torch.from_numpy(g), tx, tl, lse)
    want = torch.func.vjp(lambda a: tfk.softmax_xent_fwd_reference(
        a, tl)[0], tx)[1](torch.from_numpy(g))[0]
    np.testing.assert_allclose(dx.numpy(), want.numpy(), **TOL)


# -- F.cross_entropy --------------------------------------------------------

CE_CASES = {
    "hard": dict(),
    "ignore": dict(ignore_index=3),
    "smoothing": dict(label_smoothing=0.1),
    "soft": dict(soft_label=True),
    "weight": dict(weight=True),
    "weight_smoothing": dict(weight=True, label_smoothing=0.2),
    "no_softmax": dict(use_softmax=False),
}


def _ce_inputs(case, label_2d, seed=2):
    rng = np.random.RandomState(seed)
    n, c = 12, 7
    x = (rng.randn(n, c) * 2).astype(np.float32)
    if case == "no_softmax":
        x = np.abs(x) / np.abs(x).sum(-1, keepdims=True)
    if case == "soft":
        lab = rng.rand(n, c).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = rng.randint(0, c, (n, 1) if label_2d else n).astype(np.int64)
        lab.reshape(-1)[[1, 5]] = 3 if case == "ignore" else -100
    w = (rng.rand(c) + 0.5).astype(np.float32)
    return x, lab, w


# soft labels have one layout, (N, C); hard ones (N,) and (N, 1)
CE_PARAMS = [pytest.param(case, label_2d,
                          id=f"{case}-{'N1' if label_2d else 'N'}")
             for case in sorted(CE_CASES) for label_2d in (False, True)
             if not (case == "soft" and label_2d)]


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("case,label_2d", CE_PARAMS)
def test_cross_entropy_matches_jax(case, label_2d, reduction):
    kw = dict(CE_CASES[case])
    x, lab, w = _ce_inputs(case, label_2d)
    use_w = kw.pop("weight", False)

    def jfun(a):
        out = pt.nn.functional.cross_entropy(
            Tensor(a), Tensor(jnp.asarray(lab)),
            weight=Tensor(jnp.asarray(w)) if use_w else None,
            reduction=reduction, **kw)._data
        return out.sum(), out

    (_, jout), jgrad = jax.value_and_grad(jfun, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = F.cross_entropy(tx, torch.from_numpy(lab),
                          weight=torch.from_numpy(w) if use_w else None,
                          reduction=reduction, **kw)
    out.sum().backward()
    assert out.dtype == torch.float32
    assert tuple(out.shape) == tuple(jout.shape)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), **TOL)


def test_cross_entropy_routes_hard_labels_to_the_fused_kernels(monkeypatch):
    calls = []
    real = tloss.fused_softmax_xent
    monkeypatch.setattr(tloss, "fused_softmax_xent",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, lab, w = _ce_inputs("hard", False)
    tx, tl = torch.from_numpy(x), torch.from_numpy(lab)
    F.cross_entropy(tx, tl)
    F.cross_entropy(tx.reshape(3, 4, 7), tl.reshape(3, 4, 1))
    assert len(calls) == 2
    # the reference's own plain routes: soft labels, class weights, no
    # softmax, a class axis other than the last
    soft, _, _ = _ce_inputs("soft", False)
    F.cross_entropy(tx, torch.from_numpy(soft), soft_label=True)
    F.cross_entropy(tx, tl, weight=torch.from_numpy(w))
    F.cross_entropy(tx.softmax(-1), tl, use_softmax=False)
    F.cross_entropy(tx.t(), tl[None, :], axis=0)
    assert len(calls) == 2


# -- the dispatch rule: CPU -> plain version, CUDA -> kernel, never both --

class _Fake(types.SimpleNamespace):
    """Stands in for a CUDA tensor in the dispatch and the launchers'
    checks."""

    def __init__(self, shape, dtype=torch.float32, ptr=0, contiguous=True):
        super().__init__(device=torch.device("cuda", 0), shape=shape,
                         dtype=dtype, ptr=ptr, contiguous=contiguous)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self.contiguous

    def data_ptr(self):
        return self.ptr


def _forbid(*a, **k):
    raise AssertionError("a CUDA tensor reached the plain version")


def test_cuda_tensor_never_reaches_plain_xent(monkeypatch):
    monkeypatch.setattr(tfk, "softmax_xent_fwd_reference", _forbid)
    monkeypatch.setattr(tfk, "softmax_xent_bwd_reference", _forbid)
    monkeypatch.setattr(tfk, "_launch_xent_fwd",
                        lambda x, lab, ii, ls: ("loss", "lse"))
    monkeypatch.setattr(tfk, "_launch_xent_bwd",
                        lambda g, x, lab, lse, ii, ls: "dx")
    before = (tfk.softmax_xent_fwd.launches, tfk.softmax_xent_bwd.launches)
    x = _Fake((4, 30))
    assert tfk.softmax_xent_fwd(x, x) == ("loss", "lse")
    assert tfk.softmax_xent_bwd(x, x, x, x) == "dx"
    assert (tfk.softmax_xent_fwd.launches,
            tfk.softmax_xent_bwd.launches) == (before[0] + 1, before[1] + 1)


def test_cpu_xent_takes_plain_version_without_counting(monkeypatch):
    monkeypatch.setattr(tfk, "_launch_xent_fwd", _forbid)
    monkeypatch.setattr(tfk, "_launch_xent_bwd", _forbid)
    before = (tfk.softmax_xent_fwd.launches, tfk.softmax_xent_bwd.launches)
    x, labels, g = _inputs(5, 16, 0)
    loss, dx = _port_xent(x, labels, g, torch.float32)
    assert dx is not None
    assert (tfk.softmax_xent_fwd.launches,
            tfk.softmax_xent_bwd.launches) == before


def test_labels_are_converted_to_int32_once(monkeypatch):
    seen = []
    real = tfk.softmax_xent_fwd
    monkeypatch.setattr(tfk, "softmax_xent_fwd",
                        lambda x, lab, *a: seen.append(lab.dtype)
                        or real(x, lab, *a))
    x = torch.randn(4, 9)
    for dtype in (torch.int64, torch.int32):
        tfk.fused_softmax_xent(x, torch.zeros(4, dtype=dtype))
    assert seen == [torch.int32, torch.int32]


def test_xent_launchers_refuse_what_the_kernel_does_not_take():
    meta = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfk._launch_xent_fwd(meta, torch.zeros(4, dtype=torch.int32,
                                               device="meta"), -100, 0.0)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfk._launch_xent_bwd(meta, meta, meta, meta, -100, 0.0)
    x, lab = _Fake((4, 30)), _Fake((4,), torch.int32)
    tfk._check_xent(x, lab, _Fake((4,)))         # what the kernel takes
    refused = {
        "2-D": (_Fake((4, 3, 10)), lab),
        "V > 0": (_Fake((4, 0)), lab),
        "dtype": (_Fake((4, 30), torch.float16), lab),
        "16-byte aligned": (_Fake((4, 30), ptr=4), lab),
        "contiguous": (_Fake((4, 30), contiguous=False), lab),
        "labels must be contiguous torch.int32": (x, _Fake((4,),
                                                           torch.int64)),
        r"torch.int32 \(4,\)": (x, _Fake((5,), torch.int32)),
    }
    for match, (xx, ll) in refused.items():
        with pytest.raises(ValueError, match=match):
            tfk._check_xent(xx, ll)
    with pytest.raises(ValueError, match="lse and g"):
        tfk._check_xent(x, lab, _Fake((4,), torch.bfloat16))
    with pytest.raises(ValueError, match="2-D"):
        tfk.fused_softmax_xent(torch.zeros(2, 3, 4),
                               torch.zeros(2, 3, dtype=torch.long))
