"""The widths the port takes: LayerNorm + matmul at any hidden size, the
card wrappers' checks at every preset width, flash attention's padding
above head size 256, GPT's wide presets, and the w8a16 kernel's split
plan, on the CPU in f32 at small sizes.  (LayerNorm at 2048 and 100 and
flash at head size 320 are cases of the parity tests in
``test_torch_kernels.py`` and ``test_torch_flash.py``.)

The same numpy inputs (from a seed) go through the JAX function and its
``paddle_tpu_torch`` counterpart; on the CPU the port's wrappers run
their plain versions, and the CUDA kernels are held against those on the
card by ``chip_smoke.py``.  The card's argument checks run here on
stand-ins for CUDA tensors, with the C call stubbed.

The shapes the card refused before and takes now (the block kernels at
an output width off a multiple of 16 bytes, w8a16 at any K and N, flash
past 65535 slices) run the launchers here to their C call, and the plain
versions at those shapes against the JAX package's; the LayerNorm
backward's summation plan (the row partition, each block's partial row
of dw and db, the block-order reduce) is held against the JAX kernel in
interpret mode.

Tolerances:
 - LayerNorm + matmul against the JAX ``ln_matmul_reference``, and matmul
   + bias + gelu against ``matmul_bias_gelu_reference``: 1e-5 relative to
   the output's scale (an f32 product over d terms);
 - the w8a16 split model against ``w8a16_matmul_reference``: 1e-5, and
   identical bits for a row at every batch size; the port's plain w8a16
   against the JAX one: 1e-5;
 - the LayerNorm backward's split model against the JAX kernel's dx, dw
   and db: 1e-5 relative to each output's scale (f32 sums over the rows
   in another order).
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.incubate.models import gpt as jgpt
from paddle_tpu.ops import fused_kernels as jfk
from paddle_tpu.ops import quant_kernels as jqk
from paddle_tpu_torch.incubate.models import gpt as tgpt
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_kernels as tfk
from paddle_tpu_torch.ops import pallas_ops as tpo
from paddle_tpu_torch.ops import quant_kernels as tqk
from paddle_tpu_torch import train

# 2048: GPT-1.3B's hidden size, past the kernels' old bound of 1024;
# 100: not a multiple of 8
WIDTHS = [2048, 100]
# every hidden size of the JAX package's GPT and BERT presets
PRESET_WIDTHS = [768, 1024, 2048, 4096, 5120]


def _ln_inputs(rows, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, d) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.randn(d)).astype(np.float32)
    b = (0.2 * rng.randn(d)).astype(np.float32)
    g = rng.randn(rows, d).astype(np.float32)
    r = rng.randn(rows, d).astype(np.float32)
    return x, w, b, g, r


# -- LayerNorm and LayerNorm + matmul at any width ---------------------------

@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("d", WIDTHS)
def test_ln_matmul_matches_jax_reference_at_any_width(d, residual):
    x, lw, lb, _, r = _ln_inputs(5, d, d + 1)
    rng = np.random.RandomState(d + 2)
    w = (rng.randn(d, 24) * 0.05).astype(np.float32)
    bias = (0.1 * rng.randn(24)).astype(np.float32)
    res = r if residual else None
    want = jfk.ln_matmul_reference(
        *(None if a is None else jnp.asarray(a)
          for a in (x, w, lw, lb, bias, res)), 1e-5)
    targs = [None if a is None else torch.from_numpy(a)
             for a in (x, w, lw, lb, bias, res)]
    got = tfk.fused_ln_matmul(*targs[:5], targs[5], epsilon=1e-5)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 * scale, rtol=1e-5)


# -- what the card's wrappers accept ------------------------------------------

class _Fake(types.SimpleNamespace):
    """Stands in for a CUDA tensor, contiguous unless given ``strides``:
    enough for the launchers' checks, their output allocation and the C
    call's pointers."""

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return getattr(self, "strides", None) in (None, self._packed())

    def _packed(self):
        return tuple(int(np.prod(self.shape[j + 1:]))
                     for j in range(len(self.shape)))

    def data_ptr(self):
        return 0

    def element_size(self):
        return self.dtype.itemsize

    def stride(self, i=None):
        st = getattr(self, "strides", None) or self._packed()
        return st if i is None else st[i]

    def __getitem__(self, i):
        if not isinstance(i, tuple):
            return _fake(self.shape[1:], self.dtype)
        # a view by slices (an Ellipsis standing for whole dims): its shape,
        # the same strides
        if Ellipsis in i:
            at = i.index(Ellipsis)
            i = (i[:at] + (slice(None),) * (len(self.shape) - len(i) + 1)
                 + i[at + 1:])
        i = i + (slice(None),) * (len(self.shape) - len(i))
        shape = tuple(len(range(*sl.indices(n)))
                      for sl, n in zip(i, self.shape))
        return _fake(shape, self.dtype, strides=self.stride())

    def unsqueeze(self, dim):
        assert dim == 0
        return _fake((1, *self.shape), self.dtype, strides=(
            int(np.prod(self.shape)), *self.stride()))

    def zero_(self):
        return self

    def new_zeros(self, shape):
        return _fake(shape, self.dtype)

    def __setitem__(self, i, value):
        pass


def _fake(shape, dtype=torch.bfloat16, strides=None):
    return _Fake(device=torch.device("cuda", 0), shape=tuple(shape),
                 dtype=dtype, strides=None if strides is None
                 else tuple(strides))


@pytest.fixture
def stub_c(monkeypatch):
    """The launchers run to their C call: outputs are stand-ins, and the
    library records each entry's call and reports success."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            return lambda *args: calls.append((fn, args)) or 0

    def empty(*size, dtype=None, device=None):
        shape = size[0] if len(size) == 1 and isinstance(size[0], tuple) \
            else size
        return _fake(shape, dtype)

    monkeypatch.setattr(_build, "load", lambda name, sig: Lib())
    monkeypatch.setattr(tfk.torch, "empty", empty)
    monkeypatch.setattr(tfk.torch, "empty_like",
                        lambda t: _fake(t.shape, t.dtype))
    monkeypatch.setattr(tfk, "_stream", lambda dev: 0)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", PRESET_WIDTHS + [1003])
def test_layer_norm_launchers_take_every_preset_width(stub_c, d, dtype):
    x, vec = _fake((64, d), dtype), _fake((d,), dtype)
    tfk._launch_fwd(x, vec, vec, 1e-5, x)
    tfk._launch_bwd(x, x, vec, _fake((64,), torch.float32),
                    _fake((64,), torch.float32), x)
    assert [(fn, args[8 if fn.endswith("fwd") else 12]) for fn, args
            in stub_c] == [("ptt_layer_norm_fwd", d),
                           ("ptt_layer_norm_bwd", d)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", PRESET_WIDTHS + [1003])
def test_ln_matmul_launcher_takes_every_preset_width(stub_c, d, dtype):
    """The kernel gets K padded to a multiple of 8 and the true width,
    by which it divides the row statistics."""
    kp, n = -(-d // 8) * 8, 3 * -(-d // 8) * 8
    x, vec = _fake((64, d), dtype), _fake((d,), dtype)
    w, bias = _fake((d, n), dtype), _fake((n,), dtype)
    tfk._launch_ln_matmul(x, w, vec, vec, bias, x, 1e-5)
    (fn, args), = stub_c
    assert fn == "ptt_ln_matmul" and args[7:11] == (64, kp, d, n)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1024, 1003])
def test_matmul_bias_gelu_launcher_pads_k_to_a_multiple_of_8(stub_c, k,
                                                             dtype):
    x, w, bias = _fake((64, k), dtype), _fake((k, 4096), dtype), \
        _fake((4096,), dtype)
    tfk._launch_matmul_bias_gelu(x, w, bias, True)
    (fn, args), = stub_c
    assert fn == "ptt_matmul_bias_gelu" and args[5:8] == (
        64, -(-k // 8) * 8, 4096)


@pytest.mark.parametrize("k", [1024, 1003])
def test_bf16_matmul_bias_gelu_takes_a_transposed_weight(stub_c, k):
    """The transposed view of an (N, K) table reaches the bf16 kernel read
    in place (its own strides, k contiguous); at K = 1003 the wrapper's
    zero-padded copy, 1008 rows, n contiguous."""
    n = 4096
    x, bias = _fake((64, k)), _fake((n,))
    w = _fake((k, n), strides=(1, k))
    tfk._launch_matmul_bias_gelu(x, w, bias, True)
    (fn, args), = stub_c
    kp = -(-k // 8) * 8
    assert fn == "ptt_matmul_bias_gelu"
    assert args[5:10] == ((64, kp, n, 1, k) if k == kp else
                          (64, kp, n, n, 1))
    assert args[11] == 1   # bfloat16


def test_ln_matmul_pads_k_with_zeros():
    w = torch.arange(12.0).reshape(4, 3)
    for t, dim in ((w, 0), (w.t(), 1), (w[0], 0)):
        got = tfk._pad_k(t, 8, dim)
        assert got.shape[dim] == 8 and got.is_contiguous()
        assert torch.equal(got.narrow(dim, 0, t.shape[dim]), t)
        assert float(got.narrow(dim, t.shape[dim], 8 - t.shape[dim]).abs()
                     .sum()) == 0.0
    assert tfk._pad_k(None, 8, 0) is None


# -- flash attention above head size 256 -------------------------------------

def test_flash_pads_wide_heads_to_multiples_of_128():
    for d, want in ((257, 384), (320, 384), (384, 384), (385, 512),
                    (512, 512)):
        padded = tpo._padded(torch.ones(1, 3, 2, d), torch.ones(1, 5, 2, d))
        assert [t.shape[-1] for t in padded] == [want, want]
        assert float(padded[1][..., d:].abs().sum()) == 0.0
    q = _fake((1, 40, 2, 384))
    assert tpo._check(q, q, q)[0] == (1, 40, 40, 2, 384)
    with pytest.raises(ValueError, match="head dim 320"):
        tpo._check(*[_fake((1, 40, 2, 320))] * 3)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_flash_fwd_reads_qkv_slices_in_place(stub_c, monkeypatch, d):
    """q, k and v as the slices of one (B, S, H, 3 D) projection: the C
    entry gets their strides unchanged (the wgmma forward's tensor maps
    read them in place) and the unpadded head size."""
    monkeypatch.setattr(tpo.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    b, s, h = 2, 1024, 16
    st = (s * h * 3 * d, h * 3 * d, 3 * d, 1)
    q, k, v = (_fake((b, s, h, d), strides=st) for _ in range(3))
    tpo._launch_fwd(q, k, v, None, True, d ** -0.5, 0.0)
    (fn, args), = stub_c
    assert fn == "ptt_flash_fwd"
    assert args[13:15] == (None, 0)      # fixed lengths: no unit table
    assert list(args[15]) == [*st[:3]] * 3 + [0, 0, 0]
    assert args[16:21] == (b, h, s, s, d) and args[-4:-2] == (1, 1)
    assert list(args[-1]) == [0, 0, 0, 0]    # the dropout hash's own base


# -- GPT's wide presets ---------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt_1p3b", "gpt_6p7b", "gpt_13b"])
def test_wide_gpt_presets_equal_the_jax_ones(name):
    port, ref = getattr(tgpt, name)(), getattr(jgpt, name)()
    fields = [f.name for f in dataclasses.fields(port)]
    assert {f: getattr(port, f) for f in fields} == \
        {f: getattr(ref, f) for f in fields}
    assert train.CONFIGS[name] is getattr(tgpt, name)
    kw = getattr(tgpt, name)(use_recompute=True, hidden_dropout_prob=0.0)
    assert (kw.use_recompute, kw.hidden_dropout_prob, kw.hidden_size) == \
        (True, 0.0, port.hidden_size)


# -- the w8a16 kernel's split plan ---------------------------------------------

@pytest.mark.parametrize("k", [256, 1024, 4096, 96])
def test_w8a16_split_plan_cuts_k_into_equal_groups(k):
    plan = tqk.w8a16_split_plan(k)
    assert len(plan) == tqk.W8A16_GROUPS
    assert plan[0][0] == 0 and plan[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert len({hi - lo for lo, hi in plan}) == 1


def test_w8a16_split_model_matches_reference_and_keeps_rows():
    rng = np.random.RandomState(31)
    x = torch.from_numpy(rng.randn(64, 256).astype(np.float32))
    wq, sc = tqk.quantize_weight(
        torch.from_numpy((rng.randn(256, 32) * 0.02).astype(np.float32)),
        axis=1)
    full = tqk.w8a16_split_reference(x, wq, sc)
    np.testing.assert_allclose(full.numpy(), tqk.w8a16_matmul_reference(
        x, wq, sc).numpy(), atol=1e-5, rtol=1e-5)
    for m in (1, 2, 5, 16, 17):
        assert torch.equal(tqk.w8a16_split_reference(x[:m], wq, sc),
                           full[:m])


# -- the shapes the card refused before ------------------------------------------

# BERT's unpadded uncased vocabulary, and FFN widths off a multiple of 8
NARROW_N = [30522, 4090, 3070]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", NARROW_N)
def test_block_launchers_take_any_output_width(stub_c, n, dtype):
    """Rows 11-12 at an N off a multiple of 16 bytes: a Linear weight whose
    rows are not 16 bytes apart reaches the kernels as a zero-padded copy
    (rows ``npad`` apart, read to column n); ln_matmul's y is ``(rows, n)``
    contiguous, matmul + bias + gelu's y and z ``(rows, n)`` views of rows
    ``npad`` apart, as its TMA store writes them."""
    npad = -(-n // (16 // dtype.itemsize)) * (16 // dtype.itemsize)
    x, vec = _fake((64, 768), dtype), _fake((768,), dtype)
    w, bias = _fake((768, n), dtype), _fake((n,), dtype)
    y = tfk._launch_ln_matmul(x, w, vec, vec, bias, None, 1e-5)
    yg, zg = tfk._launch_matmul_bias_gelu(x, w, bias, True)
    (f1, a1), (f2, a2) = stub_c
    assert f1 == "ptt_ln_matmul" and a1[7:13] == (64, 768, 768, n, npad, 1)
    assert f2 == "ptt_matmul_bias_gelu"
    assert a2[5:11] == (64, 768, n, npad, 1, npad)
    assert y.shape == yg.shape == zg.shape == (64, n)
    assert y.is_contiguous() and yg.stride() == zg.stride() == (npad, 1)


def test_tied_decoder_at_the_uncased_vocabulary_is_read_in_place(stub_c):
    """BERT's decoder at V = 30522: the transposed view of the (30522, 768)
    word-embedding table reaches the bf16 kernel with its own strides (k
    contiguous, rows 768 apart); nothing copies it."""
    class Table(_Fake):
        def new_zeros(self, shape):
            raise AssertionError("the embedding table was copied")

    v, h = 30522, 768
    w = Table(device=torch.device("cuda", 0), shape=(h, v),
              dtype=torch.bfloat16, strides=(1, h))
    x, vec = _fake((4096, h)), _fake((h,))
    y = tfk._launch_ln_matmul(x, w, vec, vec, _fake((v,)), None, 1e-12)
    (fn, args), = stub_c
    assert fn == "ptt_ln_matmul" and args[4] == 0
    assert args[7:13] == (4096, h, h, v, 1, h) and args[14] == 1
    assert y.shape == (4096, v) and y.is_contiguous()


@pytest.mark.parametrize("k,n", [(48, 1000), (1024, 4096), (40, 16)])
def test_w8a16_launcher_takes_any_k_and_n(stub_c, monkeypatch, k, n):
    """x's columns are zero-padded to the next multiple of 32 (the
    kernel's x width and sum order), the weight is passed whole with its
    true K and N."""
    monkeypatch.setattr(tqk.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    x = _fake((16, k), torch.float32)
    out = tqk._launch(x, _fake((k, n), torch.int8),
                      _fake((n,), torch.float32))
    (fn, args), = stub_c
    assert fn == "ptt_w8a16_matmul"
    assert args[4:9] == (16, -(-k // 32) * 32, k, n, 0)
    assert out.shape == (16, n)


def test_flash_launchers_take_more_than_65535_slices(stub_c, monkeypatch):
    """B * H = 4097 * 16 = 65552 fixed-length slices, and a packed batch of
    65540 heads: the launchers pass them to the C entries, which fold the
    slices into gridDim.x."""
    monkeypatch.setattr(tpo.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    q = _fake((4097, 64, 16, 64))
    tpo._launch_fwd(q, q, q, None, True, 0.125, 0.0)
    tables = {name: _fake(shape, torch.int32) for name, shape in (
        ("cu_q", (3,)), ("cu_k", (3,)), ("hstart", (4,)),
        ("q_tiles", (3, 2)), ("k_tiles", (3, 2)), ("dq_units", (2, 3)),
        ("dkv_units", (5, 3)))}
    layout = types.SimpleNamespace(n=2, tables=lambda dev, causal: tables)
    qp = _fake((150, 65540, 64))
    for launch in (tpo._launch_fwd,):
        launch(qp, qp, qp, None, True, 0.125, 0.0, layout=layout)
    stats = _fake((65540, 150), torch.float32)
    tpo._launch_dq(qp, qp, qp, qp, stats, stats, None, True, 0.125, 0.0,
                   layout=layout)
    tpo._launch_dkv(qp, qp, qp, qp, stats, stats, None, True, 0.125, 0.0,
                    layout=layout)
    assert [fn for fn, _ in stub_c] == ["ptt_flash_fwd", "ptt_flash_fwd",
                                        "ptt_flash_bwd_dq",
                                        "ptt_flash_bwd_dkv"]
    assert stub_c[0][1][16:21] == (4097, 16, 64, 64, 64)
    # every packed entry: the tile table's count, then the unit table's
    # (the forward's and dq's q units, dk/dv's k units), then the batch
    # and heads
    fwd, dq, dkv = stub_c[1][1], stub_c[2][1], stub_c[3][1]
    assert fwd[12] == 3 and fwd[14] == 2 and fwd[16:18] == (2, 65540)
    assert dq[14:17] == (3, 0, 2) and dq[18:20] == (2, 65540)
    assert dkv[15:18] == (3, 0, 5) and dkv[19:21] == (2, 65540)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("n", [30522])
def test_block_plain_versions_match_jax_at_the_uncased_vocabulary(n,
                                                                  residual):
    """The plain versions the card's kernels are held to, at N = 30522
    (rows 11 and 12) against the JAX package's references, f32."""
    rng = np.random.RandomState(n)
    k = 64
    x, lw, lb, _, r = _ln_inputs(6, k, 7)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    bias = (0.1 * rng.randn(n)).astype(np.float32)
    res = r if residual else None
    t = {name: None if a is None else torch.from_numpy(a) for name, a in
         dict(x=x, w=w, lw=lw, lb=lb, bias=bias, res=res).items()}
    j = {name: None if a is None else jnp.asarray(a) for name, a in
         dict(x=x, w=w, lw=lw, lb=lb, bias=bias, res=res).items()}
    got = tfk.ln_matmul_reference(t["x"], t["w"], t["lw"], t["lb"],
                                  t["bias"], t["res"], 1e-5)
    want = np.asarray(jfk.ln_matmul_reference(j["x"], j["w"], j["lw"],
                                              j["lb"], j["bias"], j["res"],
                                              1e-5))
    assert got.shape == (6, n)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                               rtol=1e-5)
    xg = x + r if residual else x   # any input will do for the product
    for approximate in (True, False):
        got, _ = tfk.matmul_bias_gelu_reference(
            torch.from_numpy(xg), t["w"], t["bias"], approximate)
        want = np.asarray(jfk.matmul_bias_gelu_reference(
            jnp.asarray(xg), j["w"], j["bias"], approximate))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   rtol=1e-5)


def test_w8a16_plain_versions_match_jax_at_any_k_and_n():
    """w8a16 at K = 48, N = 1000 (a hidden size the int8 serve path could
    not take on the card): the port's plain version against the JAX
    reference, and the split model (K padded to 64: groups of 8, the last
    two empty) against both, each row the same bits at every batch size."""
    rng = np.random.RandomState(48)
    x = rng.randn(20, 48).astype(np.float32)
    w = (rng.randn(48, 1000) * 0.02).astype(np.float32)
    wq, sc = tqk.quantize_weight(torch.from_numpy(w), axis=1)
    jwq, jsc = jqk.quantize_weight(jnp.asarray(w), axis=1)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    want = np.asarray(jqk.w8a16_matmul_reference(jnp.asarray(x), jwq, jsc))
    got = tqk.w8a16_matmul_reference(torch.from_numpy(x), wq, sc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert tqk.w8a16_split_plan(48) == ((0, 8), (8, 16), (16, 24), (24, 32),
                                        (32, 40), (40, 48), (48, 48),
                                        (48, 48))
    full = tqk.w8a16_split_reference(torch.from_numpy(x), wq, sc)
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5, rtol=1e-5)
    for m in (1, 5, 16, 17):
        assert torch.equal(tqk.w8a16_split_reference(
            torch.from_numpy(x[:m]), wq, sc), full[:m])


def test_packed_forward_launcher_passes_the_q_unit_table(stub_c,
                                                        monkeypatch):
    """The packed forward's C entry gets dq's unit table and its count
    (the wgmma forward walks dq's key tiles, so one table serves both),
    as dq's entry does; dk/dv's gets the k units."""
    monkeypatch.setattr(tpo.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    lay = tpo.PackedLayout([0, 300, 300, 429], [0, 150, 190, 190], 429, 190)
    layout = types.SimpleNamespace(n=lay.n, tables=lambda dev, causal:
                                   lay.tables("cpu", causal))
    q, k = _fake((429, 4, 64)), _fake((190, 4, 64))
    stats = _fake((4, 429), torch.float32)
    tpo._launch_fwd(q, k, k, None, True, 0.125, 0.0, layout=layout)
    tpo._launch_dq(q, k, k, q, stats, stats, None, True, 0.125, 0.0,
                   layout=layout)
    tpo._launch_dkv(q, k, k, q, stats, stats, None, True, 0.125, 0.0,
                    layout=layout)
    (f0, fwd), (f1, dq), (f2, dkv) = stub_c
    assert (f0, f1, f2) == ("ptt_flash_fwd", "ptt_flash_bwd_dq",
                            "ptt_flash_bwd_dkv")
    t = lay.tables("cpu", True)
    units, kunits = t["dq_units"], t["dkv_units"]
    assert units.tolist() == [list(e) for e in lay.units("q", True)]
    assert fwd[13:15] == (units.data_ptr(), 3) == dq[15:17]
    assert dkv[16:18] == (kunits.data_ptr(), kunits.shape[0])
    assert fwd[11:13] == (t["q_tiles"].data_ptr(), t["q_tiles"].shape[0])


# -- the LayerNorm forward's plan and sum order ---------------------------------

@pytest.mark.parametrize("rows", [1, 7, 8, 100, 528, 529, 2048, 4096, 16384,
                                  16385])
def test_layer_norm_forward_plan_reads_rows_alone(rows):
    """The staged forward's blocks own contiguous row ranges, at most 528
    of them (four on each of an H100's SMs), none empty; a block's warps
    (8, 4, 2 or 1) take its rows r0 + w, r0 + w + warps, ...: every row
    once."""
    nblocks, per = tfk.ln_fwd_plan(rows)
    assert 1 <= nblocks <= 528 and (nblocks - 1) * per < rows
    for warps in (8, 4, 2, 1):
        seen = []
        for p in range(nblocks):
            r0, r1 = p * per, min((p + 1) * per, rows)
            for w in range(warps):
                n = (r1 - r0 - w + warps - 1) // warps if r1 - r0 > w else 0
                seen += [r0 + w + k * warps for k in range(n)]
        assert sorted(seen) == list(range(rows))


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("d", [768, 1003, 2048, 5120])
def test_layer_norm_forward_lane_model_matches_jax_kernel(d, residual):
    """The staged forward's sum order (each lane's columns chunk by chunk,
    then the xor butterfly over the lanes), modelled, gives the JAX
    ``_ln_fwd_kernel``'s y, mean and rstd, run in interpret mode, f32,
    within 1e-5 (sums over d in another order)."""
    rows = 24
    x, w, b, _, r = _ln_inputs(rows, d, d + 11)
    d_pad = -(-d // 128) * 128

    def pad(a):
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, d_pad - d)))
    want = jfk._ln_pallas_fwd(pad(x), pad(r) if residual else None,
                              pad(w[None]), pad(b[None]), d=d, eps=1e-5,
                              block_rows=8, parallel=True, interpret=True)
    got = tfk.layer_norm_fwd_lane_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5,
        torch.from_numpy(r) if residual else None)
    for t, ref in zip(got, (np.asarray(want[0])[:, :d],
                            np.asarray(want[1])[:, 0],
                            np.asarray(want[2])[:, 0])):
        np.testing.assert_allclose(t.numpy(), ref, atol=1e-5, rtol=1e-5)


# -- the LayerNorm backward's summation plan ------------------------------------

@pytest.mark.parametrize("rows", [1, 8, 100, 2048, 4096, 16384, 16385])
def test_layer_norm_backward_plan_reads_rows_alone(rows):
    """The one-pass kernel's blocks own contiguous row ranges starting at
    multiples of 8, at most 128 of them, covering every row once; the
    register kernel keeps its grid-stride plan."""
    nparts, per = tfk.ln_bwd_plan(rows, 2048)
    assert per % 8 == 0 and nparts <= 128
    assert (nparts - 1) * per < rows <= nparts * per
    assert tfk.ln_bwd_plan(rows, 1003) == (nparts, per)
    reg, _ = tfk.ln_bwd_plan(rows, 1024)
    assert reg == min(-(-rows // 8), 256)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "no-affine"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("d", [1003, 2048, 5120])
def test_layer_norm_backward_split_model_matches_jax_kernel(d, residual,
                                                            affine):
    """The one-pass backward's sum order (each block's rows in order into a
    partial row, the partial rows in block order by 8 slices) gives the
    JAX kernel's dx, dw and db, run in interpret mode, f32."""
    rows = 100    # 13 blocks of 8 rows, the last with 4
    x, w, b, g, r = _ln_inputs(rows, d, d + 3)
    res = r if residual else None
    jargs = [jnp.asarray(x)] + ([jnp.asarray(w), jnp.asarray(b)] if affine
                                else [])
    if residual:
        fn = lambda xx, *rest: jfk.fused_layer_norm(   # noqa: E731
            xx, *rest[:-1], residual=rest[-1], interpret=True)
        jargs.append(jnp.asarray(r))
    else:
        fn = lambda *a: jfk.fused_layer_norm(*a, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(fn, *jargs)
    jgrads = vjp(jnp.asarray(g))
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tw = torch.from_numpy(w) if affine else None
    tr = torch.from_numpy(r) if residual else None
    _, mean, rstd = tfk.layer_norm_fwd_reference(
        tx, tw, torch.from_numpy(b) if affine else None, 1e-5, tr)
    dx, dw, db = tfk.layer_norm_bwd_split_reference(tg, tx, tw, mean, rstd,
                                                    tr)
    got = [dx] + ([dw, db] if affine else [])
    for t, want in zip(got, jgrads):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(t.numpy(), want, atol=1e-5 * scale,
                                   rtol=1e-5)
    if not affine:   # db without a bias: the column sums of g
        np.testing.assert_allclose(db.numpy(), g.sum(0), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g.sum(0)).max()))
