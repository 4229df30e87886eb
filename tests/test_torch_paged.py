"""The paged decode attention kernels' split design, on the CPU.

``paddle_tpu_torch.ops.paged_attention.paged_attention_split_reference``
repeats the CUDA kernels' arithmetic (splits of 128 positions, chunks of
32 per warp, exp2 of scores scaled by log2(e), int8 scales on the score
and the probability, partials merged in a fixed order).  The same numpy
inputs (from a seed) go through it and through the JAX package's
``paged_attention`` / ``paged_attention_int8``: the Pallas kernels in
interpret mode and the XLA references.  The CUDA kernels themselves are
held against the plain versions and this mirror on the card by
``chip_smoke.py``.

Lengths: 0, 1, ps, ps + 1, split - 1, split, split + 1 and the table's
full width.  A row of length 0 gives 0, as the Pallas kernel does; the
JAX reference gives the mean of V there (ROADMAP Queue 3), so it is held
on the other rows only.

Tolerances:
 - f32 and int8 pages: atol = rtol = 2e-5, the JAX package's own
   tolerance between its interpret-mode kernel and its reference (only
   the order of the f32 sums differs; the int8 scales multiply the score
   and the probability rather than each element);
 - bf16 pages: 2e-2 absolute and relative against the JAX reference on
   bf16 inputs, as ``test_paged_attention_bf16_rounds_weights_like_jax``
   (the reference rounds the probabilities to bf16, the kernels keep them
   in f32);
 - a row alone and inside a batch, and two runs: the same bits.

The launcher runs here to its C call on stand-ins for CUDA tensors: the
split count, the workspace and the scale it passes, at every head size
and page dtype it takes, each call adding one to its counter.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import quant_kernels as jqk
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import paged_attention as tpa

H, D = 2, 8
SPLIT = tpa.SPLIT_TOKENS


def _lengths(ps, maxp):
    return np.array([0, 1, ps, ps + 1, SPLIT - 1, SPLIT, SPLIT + 1,
                     maxp * ps], np.int32)


def _inputs(seed, ps, maxp, b=8):
    rng = np.random.RandomState(seed)
    pages = 1 + b * maxp
    q = rng.randn(b, H, D).astype(np.float32)
    k = rng.randn(pages, ps, H, D).astype(np.float32)
    v = rng.randn(pages, ps, H, D).astype(np.float32)
    tables = (rng.permutation(pages - 1)[:b * maxp] + 1) \
        .reshape(b, maxp).astype(np.int32)
    return q, k, v, tables


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _quantized(k, v):
    kq, ks = (np.asarray(a) for a in jqk.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jqk.quantize_kv(jnp.asarray(v)))
    return kq, vq, ks, vs


# (page size, pages per row): 160 positions in two splits
PAGINGS = [(16, 10), (32, 5)]


@pytest.mark.parametrize("ps,maxp", PAGINGS)
def test_split_mirror_matches_jax_f32(ps, maxp):
    q, k, v, tables = _inputs(ps, ps, maxp)
    lengths = _lengths(ps, maxp)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, lengths)]
    kernel = np.asarray(jpa.paged_attention(*jargs, use_pallas=True,
                                            interpret=True))
    ref = np.asarray(jpa.paged_attention_reference(*jargs))
    out = tpa.paged_attention_split_reference(*_t(q, k, v, tables, lengths))
    assert out.dtype == torch.float32 and out.shape == (8, H, D)
    out = out.numpy()
    assert not out[0].any() and not kernel[0].any()
    np.testing.assert_allclose(out, kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out[1:], ref[1:], atol=2e-5, rtol=2e-5)
    # the port's CPU path is the plain reference: the same on live rows
    plain = tpa.paged_attention(*_t(q, k, v, tables, lengths)).numpy()
    np.testing.assert_allclose(out[1:], plain[1:], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("ps,maxp", PAGINGS)
def test_split_mirror_matches_jax_int8(ps, maxp):
    q, k, v, tables = _inputs(ps + 1, ps, maxp)
    kq, vq, ks, vs = _quantized(k, v)
    lengths = _lengths(ps, maxp)
    jargs = [jnp.asarray(a) for a in (q, kq, vq, ks, vs, tables, lengths)]
    kernel = np.asarray(jpa.paged_attention_int8(*jargs, use_pallas=True,
                                                 interpret=True))
    ref = np.asarray(jpa.paged_attention_int8_reference(*jargs))
    tq, tkq, tvq, tks, tvs, tt, tl = _t(q, kq, vq, ks, vs, tables, lengths)
    out = tpa.paged_attention_split_reference(
        tq, tkq, tvq, tt, tl, k_scale=tks, v_scale=tvs).numpy()
    assert not out[0].any() and not kernel[0].any()
    np.testing.assert_allclose(out, kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out[1:], ref[1:], atol=2e-5, rtol=2e-5)
    plain = tpa.paged_attention_int8(tq, tkq, tvq, tks, tvs, tt, tl).numpy()
    np.testing.assert_allclose(out[1:], plain[1:], atol=2e-5, rtol=2e-5)


def test_split_mirror_bf16_matches_jax_reference():
    ps, maxp = PAGINGS[0]
    q, k, v, tables = _inputs(9, ps, maxp)
    lengths = _lengths(ps, maxp)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jpa.paged_attention_reference(
        *bf, jnp.asarray(tables), jnp.asarray(lengths)), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tpa.paged_attention_split_reference(tq, tk, tv,
                                              *_t(tables, lengths))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert not out[0].any()
    np.testing.assert_allclose(out[1:], want[1:], atol=2e-2, rtol=2e-2)


def _mirror_args(kind, seed, b):
    ps, maxp = PAGINGS[0]
    q, k, v, tables = _inputs(seed, ps, maxp, b=b)
    lengths = np.resize(_lengths(ps, maxp), b)
    if kind == "int8":
        kq, vq, ks, vs = _quantized(k, v)
        tq, tkq, tvq, tks, tvs, tt, tl = _t(q, kq, vq, ks, vs, tables,
                                            lengths)
        return (tq, tkq, tvq, tt, tl), dict(k_scale=tks, v_scale=tvs)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    return (tq, tk, tv, *_t(tables, lengths)), {}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_split_mirror_row_alone_is_the_row_in_a_batch(kind):
    (q, k, v, tables, lengths), kw = _mirror_args(kind, 11, 16)
    batch = tpa.paged_attention_split_reference(q, k, v, tables, lengths,
                                                **kw)
    again = tpa.paged_attention_split_reference(q, k, v, tables, lengths,
                                                **kw)
    assert torch.equal(batch, again)
    for r in range(q.shape[0]):
        alone = tpa.paged_attention_split_reference(
            q[r:r + 1], k, v, tables[r:r + 1], lengths[r:r + 1], **kw)
        assert torch.equal(alone[0], batch[r]), r


@pytest.mark.parametrize("b", [2, 4, 8, 16])
def test_split_plan_does_not_depend_on_the_batch(b):
    # gpt_345m's serve table: 128 pages of 16 (max_seq_len 2048)
    for ps, maxp in ((16, 128), (32, 64)):
        pages = torch.empty(1 + b * maxp, ps, H, D)
        tables = torch.zeros(b, maxp, dtype=torch.int32)
        assert tpa.split_plan(pages, tables) == (SPLIT, 16)
    assert tpa.split_plan(torch.empty(9, 16, H, D),
                          torch.zeros(b, 9, dtype=torch.int32)) == (SPLIT, 2)
    # a row's bits: alone, and as the last row of a batch of b
    (q, k, v, tables, lengths), _ = _mirror_args("f32", 12, b)
    batch = tpa.paged_attention_split_reference(q, k, v, tables, lengths)
    alone = tpa.paged_attention_split_reference(
        q[-1:], k, v, tables[-1:], lengths[-1:])
    assert torch.equal(alone[0], batch[-1])


# -- the launcher, to its C call, on stand-ins for CUDA tensors ---------------

class _Fake(types.SimpleNamespace):
    """A CUDA tensor's device, shape and dtype; no values to read."""

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0

    def element_size(self):
        return self.dtype.itemsize


def _fake(shape, dtype):
    return _Fake(device=torch.device("cuda", 0), shape=tuple(shape),
                 dtype=dtype)


@pytest.fixture
def stub_c(monkeypatch):
    """``_launch`` runs to its C call: the library records the call and
    reports success; allocations are stand-ins."""
    calls = []

    class Lib:
        def ptt_paged_attention(self, *args):
            calls.append(args)
            return 0

    def empty(size, dtype=None, device=None):
        return _fake((size,), dtype)

    monkeypatch.setattr(_build, "load", lambda name, sig: Lib())
    monkeypatch.setattr(tpa.torch, "empty", empty)
    monkeypatch.setattr(tpa.torch, "empty_like",
                        lambda t: _fake(t.shape, t.dtype))
    monkeypatch.setattr(tpa.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    return calls


def _fake_call(pages, d, b=16, ps=16, maxp=128, n_pages=2049):
    qdt = torch.bfloat16 if pages == torch.bfloat16 else torch.float32
    q = _fake((b, H, d), qdt)
    kv = _fake((n_pages, ps, H, d), pages)
    pt = _fake((b, maxp), torch.int32)
    ln = _fake((b,), torch.int32)
    if pages == torch.int8:
        sc = _fake((n_pages, ps, H), torch.float32)
        return tpa.paged_attention_int8, (q, kv, kv, sc, sc, pt, ln)
    return tpa.paged_attention, (q, kv, kv, pt, ln)


# every (pages, head size) the wrapper takes: D * element size a multiple
# of 16 bytes, D / (16 / element size) a power of two up to 32
TAKEN = [(torch.float32, d) for d in (4, 8, 16, 32, 64, 128)] \
    + [(torch.bfloat16, d) for d in (8, 16, 32, 64, 128, 256)] \
    + [(torch.int8, d) for d in (16, 32, 64, 128, 256, 512)]


@pytest.mark.parametrize("pages,d", TAKEN,
                         ids=[f"{str(p)[6:]}-{d}" for p, d in TAKEN])
def test_launcher_takes_every_head_size_it_took(stub_c, pages, d):
    fn, args = _fake_call(pages, d)
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before + 1
    assert out.shape == (16, H, d)
    (call,) = stub_c
    # (..., out, ws, B, H, D, ps, max_pages, num_pages, n_splits, scale,
    #  q dtype, kv dtype, stream)
    assert call[9:16] == (16, H, d, 16, 128, 2049, 16)
    assert call[16] == pytest.approx(np.log2(np.e) / np.sqrt(d))
    assert call[17:] == (1 if pages == torch.bfloat16 else 0,
                         {torch.float32: 0, torch.bfloat16: 1,
                          torch.int8: 2}[pages], 7)


@pytest.mark.parametrize("pages,d", [(torch.float32, 48),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 4),
                                     (torch.int8, 8)])
def test_launcher_refuses_head_sizes_the_kernel_never_took(stub_c, pages, d):
    fn, args = _fake_call(pages, d)
    with pytest.raises(ValueError, match="head_dim"):
        fn(*args)
    assert stub_c == []


@pytest.mark.parametrize("ps,maxp,splits", [(16, 128, 16), (32, 64, 16),
                                            (16, 9, 2), (1, 300, 3),
                                            (3, 43, 2)])
def test_launcher_passes_the_split_plan_and_its_workspace(
        stub_c, monkeypatch, ps, maxp, splits):
    sizes = []
    monkeypatch.setattr(tpa.torch, "empty", lambda size, dtype=None,
                        device=None: sizes.append((size, dtype))
                        or _fake((size,), dtype))
    fn, args = _fake_call(torch.float32, 64, b=4, ps=ps, maxp=maxp)
    fn(*args)
    (call,) = stub_c
    assert call[15] == splits
    assert sizes == [(4 * H * splits * (64 + 2), torch.float32)]


def test_each_cuda_call_counts_one_and_never_reaches_a_plain_version(
        stub_c, monkeypatch):
    def forbid(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("paged_attention_reference",
                 "paged_attention_int8_reference",
                 "paged_attention_split_reference"):
        monkeypatch.setattr(tpa, name, forbid)
    for pages in (torch.float32, torch.bfloat16, torch.int8):
        fn, args = _fake_call(pages, 64)
        for n in range(3):
            before = (tpa.paged_attention.launches,
                      tpa.paged_attention_int8.launches)
            fn(*args)
            after = (tpa.paged_attention.launches,
                     tpa.paged_attention_int8.launches)
            int8 = pages == torch.int8
            assert after == (before[0] + (not int8), before[1] + int8)
    assert len(stub_c) == 9
