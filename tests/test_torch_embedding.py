"""The port's ``F.embedding`` (a gather and a backward whose sums never
change order) against the JAX package's ``embedding``, on the CPU.

 - both backward routes: a table of 2 rows (the one-hot product, BERT's
   token types) and one of 50 (the stable sort, then the rows added in
   that order; ``index_add_`` on the CPU), with ``padding_idx`` None, 1
   and -1
   (the functional counts it from the end; the JAX functional takes the
   row's index, its layer the negative one): the forward equal, the
   weight's gradient within 1e-6 in f32 and the padding row's gradient 0;
 - bf16: the forward equal; the gradient within one bf16 step (2^-8
   relative) of the JAX package's f32 gradient of the same bf16 values,
   since the port sums in f32 and rounds once (the JAX package's bf16
   scatter-add rounds at every add);
 - four runs of the backward give the same bits (8 x 512 ids);
 - ``nn.Embedding(padding_idx=)``: the row starts at 0, as the JAX
   layer's does, and the layer matches the JAX layer's forward and
   gradient;
 - ``F.embedding`` inside a ``TrainStep``: GPT's and BERT's parity tests
   (``test_torch_train.py``, ``test_torch_bert.py``) run through it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.nn import Embedding
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import Normal

D = 12


def _inputs(rows, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, rows, (4, 33)).astype(np.int64)
    ids[0, :5] = rows - 1          # repeats of the last row, and of row 3
    ids[1, :7] = min(3, rows - 1)
    w = rng.randn(rows, D).astype(np.float32)
    g = rng.randn(4, 33, D).astype(np.float32)
    return ids, w, g


def _jax(ids, w, g, padding_idx, dtype=jnp.float32):
    def f(wt):
        return pt.nn.functional.embedding(
            Tensor(jnp.asarray(ids)), Tensor(wt),
            padding_idx=padding_idx)._data
    out, vjp = jax.vjp(f, jnp.asarray(w, dtype))
    (gw,) = vjp(jnp.asarray(g, dtype))
    return np.asarray(out.astype(jnp.float32)), np.asarray(
        gw.astype(jnp.float32))


def _port(ids, w, g, padding_idx, dtype=torch.float32):
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    out = F.embedding(torch.from_numpy(ids), wt, padding_idx=padding_idx)
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach(), wt.grad


@pytest.mark.parametrize("rows", [2, 50], ids=["one_hot", "sorted"])
@pytest.mark.parametrize("padding_idx", [None, 1, -1])
def test_embedding_matches_jax_f32(rows, padding_idx):
    ids, w, g = _inputs(rows)
    # the JAX functional compares ids with padding_idx as given
    jpad = None if padding_idx is None else padding_idx % rows
    jout, jgw = _jax(ids, w, g, jpad)
    out, gw = _port(ids, w, g, padding_idx)
    assert out.shape == (4, 33, D) and gw.shape == (rows, D)
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_allclose(gw.numpy(), jgw, rtol=0, atol=1e-6)
    if padding_idx is not None:
        assert not (ids != jpad).all()
        assert (out.numpy()[ids == jpad] == 0).all()
        assert (gw[jpad] == 0).all()


@pytest.mark.parametrize("rows", [2, 50], ids=["one_hot", "sorted"])
def test_embedding_bf16_within_one_step_of_the_f32_sum(rows):
    ids, w, g = _inputs(rows, seed=1)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    # the JAX f32 gradient of the same bf16 values
    jout, ref = _jax(ids, wb.float().numpy(), gb.float().numpy(), None)
    out, gw = _port(ids, w, g, None, torch.bfloat16)
    assert gw.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), jout)
    err = np.abs(gw.float().numpy() - ref)
    assert (err <= 2.0 ** -8 * np.abs(ref) + 1e-30).all(), err.max()


@pytest.mark.parametrize("rows", [2, 1000], ids=["one_hot", "sorted"])
def test_embedding_backward_gives_the_same_bits_every_run(rows):
    # large enough for the CPU's parallel kernels (its index_put_ with
    # accumulate=True gives other bits from run to run here)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, rows, (8, 512)).astype(np.int64)
    w = rng.randn(rows, 128).astype(np.float32)
    g = rng.randn(8, 512, 128).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        runs = [_port(ids, w, g, 0, dtype)[1] for _ in range(4)]
        for r in runs[1:]:
            assert torch.equal(r.view(torch.int16), runs[0].view(torch.int16))


@pytest.mark.parametrize("padding_idx", [2, -2])
def test_embedding_layer_padding_row_matches_jax(padding_idx):
    rows = 20
    jlayer = pt.nn.Embedding(rows, D, padding_idx=padding_idx)
    layer = Embedding(rows, D, Normal(0.0, 1.0),
                      generator=make_generator(0, "cpu"),
                      padding_idx=padding_idx)
    pad = padding_idx % rows
    assert (layer.weight[pad] == 0).all()
    assert (np.asarray(jlayer.weight._data)[pad] == 0).all()
    w = np.asarray(jlayer.weight._data)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
    ids, _, g = _inputs(rows, seed=3)
    ids[2, :4] = pad
    out = layer(torch.from_numpy(ids))
    out.backward(torch.from_numpy(g))

    def f(wt):
        jlayer.weight._data = wt
        return jlayer(Tensor(jnp.asarray(ids)))._data
    jout, vjp = jax.vjp(f, jnp.asarray(w))
    (jgw,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(layer.weight.grad.numpy(), np.asarray(jgw),
                               rtol=0, atol=1e-6)
    assert (layer.weight.grad[pad] == 0).all()


def test_embedding_records_no_data_dependent_shape():
    # the backward's every shape follows from the inputs' shapes: the same
    # operations, and no output sized by the ids' values, for any ids
    ids, w, g = _inputs(50, seed=4)
    seen = []
    for table in (ids, np.zeros_like(ids)):
        with torch.profiler.profile() as prof:
            _port(table, w, g, None)
        seen.append(sorted({e.key for e in prof.key_averages()}))
    assert seen[0] == seen[1]
    for op in ("aten::unique", "aten::nonzero", "aten::_unique2",
               "aten::bincount", "aten::item"):
        assert op not in seen[0]
