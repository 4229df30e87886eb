"""Parity of the PyTorch port's packed varlen flash attention
(``mha_packed``, ``F.flash_attn_unpadded``) with the JAX package, on the
CPU, in f32 at small sizes (2 heads of 32, totals under 100 tokens).

The same numpy inputs (from a seed) and the same int32 dropout seed go
through the JAX function and its ``paddle_tpu_torch`` counterpart.  On
the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against those on the card by ``chip_smoke.py``.  The
JAX side runs its Pallas kernels in interpret mode, jitted, once per case
(a module-scoped cache).

Tolerances, the JAX package's own (``tests/test_pallas_ops.py``):
 - out: 2e-5;
 - dq, dk and dv against ``jax.grad``: 3e-4;
 - the dropout keep mask: identical bits.
"""
import collections
import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn.functional import flash_attention as jfa
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
from paddle_tpu_torch.ops import pallas_ops as tpo

H, D = 2, 32
SEED = 12345
OUT_TOL, GRAD_TOL = 2e-5, 3e-4
PACKED = ("flash_packed_fwd", "flash_packed_bwd_dq", "flash_packed_bwd_dkv")
FIXED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# lens_q, lens_k, causal, dropout, block (block_q = block_k; None: the
# default layout, one block over the whole buffer at these totals)
CASES = {
    "self-causal-default": ([20, 0, 33, 11, 9], None, True, 0.0, None),
    "self-causal-b8-drop": ([20, 0, 33, 11, 9], None, True, 0.1, 8),
    # len_q > len_k: rows with no key under causal; an empty k sequence
    "cross-causal-b16-drop": ([20, 5, 33, 11, 9], [7, 0, 40, 11, 3], True,
                              0.1, 16),
    # an empty q sequence whose keys get no gradient
    "cross-full-b8": ([20, 5, 0, 11, 9], [7, 12, 40, 11, 3], False, 0.0, 8),
    "cross-full-default": ([20, 5, 0, 11, 9], [7, 12, 40, 11, 3], False, 0.0,
                           None),
    "self-full-default-drop": ([12, 40, 3], None, False, 0.1, None),
}


def _jseed(seed):
    return jnp.asarray(np.int32(seed).view(np.float32))


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs and the JAX results of one case: q, k, v, the output weight
    w, cu_q, cu_k, the JAX out and its (dq, dk, dv) for ``sum(out * w)``."""
    lens_q, lens_k, causal, p, block = CASES[name]
    lens_k = lens_q if lens_k is None else lens_k
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    rng = np.random.RandomState(sum(lens_q) + 7 * sum(lens_k))
    q, w = (rng.randn(cu_q[-1], H, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(cu_k[-1], H, D).astype(np.float32) for _ in range(2))

    def f(q_, k_, v_):
        return jpo.mha_packed(q_, k_, v_, jnp.asarray(cu_q), jnp.asarray(cu_k),
                              causal=causal, dropout_p=p, seed=_jseed(SEED),
                              block_q=block, block_k=block, interpret=True)

    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp(jnp.asarray(w))
    return dict(q=q, k=k, v=v, w=w, cu_q=cu_q, cu_k=cu_k, out=np.asarray(out),
                grads=[np.asarray(g) for g in grads])


def _port(name):
    lens_q, lens_k, causal, p, block = CASES[name]
    c = _case(name)
    ts = [torch.from_numpy(c[n]).requires_grad_() for n in ("q", "k", "v")]
    out = tpo.mha_packed(*ts, torch.from_numpy(c["cu_q"]),
                         torch.from_numpy(c["cu_k"]), causal=causal,
                         dropout_p=p, seed=SEED, block_q=block, block_k=block)
    (out * torch.from_numpy(c["w"])).sum().backward()
    return out.detach(), [t.grad for t in ts]


# -- (a) mha_packed against the interpret-mode JAX mha_packed ---------------

@pytest.mark.parametrize("name", list(CASES))
def test_mha_packed_out_matches_jax_interpret(name):
    out, _ = _port(name)
    np.testing.assert_allclose(out.numpy(), _case(name)["out"], atol=OUT_TOL,
                               rtol=OUT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_mha_packed_grads_match_jax_grad(name):
    _, grads = _port(name)
    for g, want, what in zip(grads, _case(name)["grads"], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=what)


def test_rows_without_a_key_and_keys_without_a_query():
    # cross-causal: sequence 0 has len_q 20 > len_k 7, so its first 13 rows
    # see no key; sequence 1 has no key at all
    out, (dq, _, _) = _port("cross-causal-b16-drop")
    assert torch.all(out[:13] == 0) and torch.all(out[20:25] == 0)
    assert torch.all(dq[:13] == 0)
    _, lse = tpo.mha_packed_reference(
        *(torch.from_numpy(_case("cross-causal-b16-drop")[n])
          for n in ("q", "k", "v", "cu_q", "cu_k")), causal=True)
    assert torch.all(lse[:, :13] == -1e30) and torch.all(lse[:, 13:20] > -1e3)
    # cross-full: the empty q sequence 2 leaves its 40 keys no gradient
    _, (_, dk, dv) = _port("cross-full-b8")
    assert torch.all(dk[19:59] == 0) and torch.all(dv[19:59] == 0)


def test_packed_bwd_reference_is_the_gradient_of_the_forward():
    # the explicit backward against autograd through the plain forward
    lens_q, lens_k = [9, 0, 30, 4], [5, 6, 31, 4]
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(sum(lens_q), 2, 16)).double()
    k, v = (torch.from_numpy(rng.randn(sum(lens_k), 2, 16)).double()
            for _ in range(2))
    do = torch.from_numpy(rng.randn(sum(lens_q), 2, 16))
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    kw = dict(causal=True, dropout_p=0.2, seed=7, block_q=8, block_k=8)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = tpo.mha_packed_reference(*ts, cu_q, cu_k, **kw)
    out.backward(do)
    grads = tpo.mha_packed_bwd_reference(
        q.float(), k.float(), v.float(), out.detach().float(),
        lse.detach().float(), do.float(), cu_q, cu_k, **kw)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(g.numpy(), t.grad.float().numpy(),
                                   atol=1e-5, rtol=1e-5)


# -- (b) the dropout keep mask over the packed buffer ------------------------

@pytest.mark.parametrize("seed", [SEED, 0x3F800000], ids=["12345", "3f800000"])
@pytest.mark.parametrize("block", [None, (8, 16)], ids=["default", "b8x16"])
def test_packed_keep_mask_equals_the_jax_tile_mask(block, seed):
    lens_q, lens_k = [20, 0, 33, 11, 9], [7, 12, 40, 0, 3]
    bq, bk = (None, None) if block is None else block
    lay = tpo.PackedLayout(_cu(lens_q), _cu(lens_k), sum(lens_q),
                           sum(lens_k), block_q=bq, block_k=bk)
    # the JAX kernel's tiles over its whole packed buffer, per head
    jbq = min(bq or 512, -(-sum(lens_q) // 8) * 8)
    jbk = min(bk or 512, -(-sum(lens_k) // 8) * 8)
    nq = -(-(lay.start_q[-1] + lens_q[-1]) // jbq) + 1
    nk = -(-(lay.start_k[-1] + lens_k[-1]) // jbk) + 1
    buffers = [np.block([[np.asarray(jpo._tile_keep_mask(
        jnp.int32(seed), h, qi, ki, jbq, jbk, 0.1)) for ki in range(nk)]
        for qi in range(nq)]) for h in range(H)]
    n = 0
    for rq, rk, _, keep in lay.pairs(True, seed, 0.1, H, "cpu"):
        s = next(i for i in range(lay.n) if lay.cu_q[i] == rq.start
                 and lay.cu_q[i + 1] == rq.stop and lay.cu_k[i] == rk.start)
        r0, c0 = lay.start_q[s], lay.start_k[s]
        want = np.stack([b[r0:r0 + rq.stop - rq.start,
                           c0:c0 + rk.stop - rk.start] for b in buffers])
        np.testing.assert_array_equal(keep.numpy(), want)
        n += 1
    assert n == 3          # the sequences with rows on both sides


def test_packed_layout_follows_the_jax_block_aligned_buffer():
    lens = [20, 0, 33, 11, 9]
    lay = tpo.PackedLayout(_cu(lens), _cu(lens), 73, 73, block_q=8,
                           block_k=16)
    # plen = ceil(len / b) * b, starts = exclusive cumsum (po:1098-1117)
    assert lay.start_q == [0, 24, 24, 64, 80]
    assert lay.start_k == [0, 32, 32, 80, 96]
    lay = tpo.PackedLayout(_cu(lens), _cu(lens), 73, 73)   # b = 80 here
    assert lay.start_q == lay.start_k == [0, 80, 80, 160, 240]
    # the kernels' tile tables: each 64-row tile of one sequence once
    t = tpo.PackedLayout(_cu([64, 0, 130]), _cu([10, 3, 200]), 194,
                         213).tables("cpu")
    assert t["q_tiles"].tolist() == [[0, 0], [2, 0], [2, 64], [2, 128]]
    assert t["k_tiles"].tolist() == [[0, 0], [1, 0], [2, 0], [2, 64],
                                     [2, 128], [2, 192]]
    assert t["cu_k"].tolist() == [0, 10, 13, 213]
    assert t["hstart"].dtype == torch.int32


# the wgmma backward's unit tables: (sequence, first tile, second tile or
# -1) over 128-row tiles, q tiles for dq and k tiles for dk/dv
BENCH_PACKED_LENS = [64, 128, 896, 256, 1024, 192, 512, 320]
BENCH_DQ_UNITS = [[4, 7, 0], [4, 6, 1], [4, 5, 2], [4, 4, 3], [2, 6, 0],
                  [2, 5, 1], [2, 4, 2], [6, 3, 0], [6, 2, 1], [2, 3, -1],
                  [7, 2, 0], [3, 1, 0], [5, 1, 0], [7, 1, -1], [0, 0, -1],
                  [1, 0, -1]]
BENCH_DKV_UNITS = [[4, 0, 7], [4, 1, 6], [4, 2, 5], [4, 3, 4], [2, 0, 6],
                   [2, 1, 5], [2, 2, 4], [6, 0, 3], [6, 1, 2], [2, 3, -1],
                   [3, 0, 1], [7, 0, 2], [5, 0, 1], [7, 1, -1], [1, 0, -1],
                   [0, 0, -1]]


def _unit_work(lay, side, causal, entry):
    lq, lk = lay.lens("q")[entry[0]], lay.lens("k")[entry[0]]
    return sum(tpo._tile_steps(side, lq, lk, t, causal) for t in entry[1:]
               if t >= 0)


def test_packed_unit_tables_pair_tiles_long_with_short_by_work():
    # q lens 64, 0, 130 and k lens 10, 3, 200: an empty q sequence whose
    # k tile still gets a unit (dk and dv written as zeros)
    lay = tpo.PackedLayout(_cu([64, 0, 130]), _cu([10, 3, 200]), 194, 213)
    for causal in (False, True):
        t = lay.tables("cpu", causal)
        assert t["dq_units"].tolist() == [[2, 1, 0], [0, 0, -1]]
        assert t["dkv_units"].tolist() == [[2, 0, 1], [0, 0, -1],
                                           [1, 0, -1]]
    # bench_packed's 8 causal sequences: 88 key-tile steps a head for dq,
    # the longest units (1024 tokens: 9 steps) first
    cu = _cu(BENCH_PACKED_LENS)
    lay = tpo.PackedLayout(cu, cu, 3392, 3392)
    t = lay.tables("cpu", True)
    assert t["dq_units"].tolist() == BENCH_DQ_UNITS
    assert t["dkv_units"].tolist() == BENCH_DKV_UNITS
    assert [_unit_work(lay, "q", True, e) for e in BENCH_DQ_UNITS] == [
        9, 9, 9, 9, 8, 8, 8, 5, 5, 4, 4, 3, 3, 2, 1, 1]
    assert [_unit_work(lay, "k", True, e) for e in BENCH_DKV_UNITS] == [
        18, 18, 18, 18, 16, 16, 16, 10, 10, 8, 6, 6, 4, 3, 2, 1]
    # full attention orders by the other side's length alone: the 320
    # tokens' pair (3 key tiles each) before the 256 tokens' (2 each)
    assert lay.units("q", False)[10:13] == [(7, 2, 0), (3, 1, 0), (5, 1, 0)]
    # one upload a device and mask: every table a view of one buffer
    assert len({v.untyped_storage().data_ptr() for v in t.values()}) == 1
    assert lay.tables("cpu", True) is t and lay.tables("cpu") is not t


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("seed", range(6))
def test_packed_units_cover_every_row_once_largest_work_first(seed, causal):
    """Walking the unit table as the kernels do (persistent block b takes
    unit b, then in round r unit r * G + b, or r * G + G - 1 - b when r is
    odd; unit u is entry u // H for head u % H, then the entry's tiles,
    128 rows each, stores stopping at the sequence's end)
    covers every (head, q row) of every sequence with q rows exactly once
    for dq, and every (head, k row) with k rows once for dk/dv: zero
    lengths on either side and cross lengths (len_q > len_k) included."""
    rng = np.random.RandomState(seed)
    n, heads, grid = rng.randint(1, 10), 3, 7
    pool = [0, 0, 1, 63, 127, 128, 129, 200, 255, 256, 257, 640, 1000]
    lens_q = list(rng.choice(pool, n)) + [5]
    lens_k = list(rng.choice(pool, n)) + [3]     # len_q > len_k last
    lay = tpo.PackedLayout(_cu(lens_q), _cu(lens_k), sum(lens_q),
                           sum(lens_k))
    t = lay.tables("cpu", causal)
    for side, name in (("q", "dq_units"), ("k", "dkv_units")):
        entries = [tuple(e) for e in t[name].tolist()]
        assert entries == lay.units(side, causal)
        work = [_unit_work(lay, side, causal, e) for e in entries]
        assert work == sorted(work, reverse=True)
        lens = lay.lens(side)
        seen = collections.Counter()
        units = len(entries) * heads
        for b in range(grid):
            for r in itertools.count():
                u = r * grid + (grid - 1 - b if r % 2 else b)
                if u >= units:
                    break
                s, *tiles = entries[u // heads]
                for tile in tiles:
                    if tile < 0:
                        continue
                    assert 0 <= tile * 128 < lens[s]
                    for row in range(tile * 128,
                                     min(lens[s], (tile + 1) * 128)):
                        seen[u % heads, s, row] += 1
        want = {(h, s, r) for h in range(heads) for s, m in enumerate(lens)
                for r in range(m)}
        assert set(seen) == want and set(seen.values()) == {1}, side


# -- the wgmma forward's walk of dq's unit table, modelled -------------------

# lens_q, lens_k, causal, dropout, block: lengths off a multiple of 128,
# len_q > len_k (300 against 150), an empty q sequence, len_k = 0 (129
# rows with no key), tiles crossing into the next sequence's rows
UNIT_CASES = {
    "causal-drop-b128": ([300, 0, 129, 17, 200], [150, 40, 0, 17, 260], True,
                         0.1, 128),
    "full-default": ([300, 0, 129, 17, 200], [150, 40, 0, 17, 260], False,
                     0.0, None),
}


def _wg_packed_forward_model(q, k, v, lay, causal, p, seed, scale):
    """The wgmma packed forward as its blocks walk the unit table: unit u
    is entry ``u // H`` of ``dq_units`` for head ``u % H``; each 128-row q
    tile of the entry reads 128 absolute rows from its sequence's first
    (crossing into the next sequence's rows, zeros past the buffer) and
    walks the 128-key tiles up to its last row's diagonal, keys read the
    same way and masked by the sequence's lengths (key < len_k, query <
    len_q, causal bottom right); an online softmax in f32 per key tile,
    the dropout hash over the block-aligned coordinates, and only rows
    below len_q stored.  Returns (out, lse, how often each (row, head)
    was stored)."""
    total_q, heads, d = q.shape
    zq, zk = torch.zeros(128, heads, d), torch.zeros(128, heads, d)
    qz, kz, vz = torch.cat([q, zq]), torch.cat([k, zk]), torch.cat([v, zk])
    out = torch.zeros_like(q)
    lse = torch.zeros(heads, total_q)
    stores = torch.zeros(total_q, heads, dtype=torch.int64)
    lens_q, lens_k = lay.lens("q"), lay.lens("k")
    entries = lay.tables("cpu", causal)["dq_units"].tolist()
    for u in range(len(entries) * heads):
        s, *tiles = entries[u // heads]
        h, sq, sk = u % heads, lens_q[s], lens_k[s]
        for tile in (t for t in tiles if t >= 0):
            q0, off = tile * 128, sk - sq
            end = min(sk, q0 + 128 + off) if causal else sk
            rows = torch.arange(q0, q0 + 128)
            at = lay.cu_q[s] + q0
            qt = qz[at:at + 128, h]
            m = torch.full((128,), -1e30)
            l, acc = torch.zeros(128), torch.zeros(128, d)
            for k0 in range(0, end, 128):
                kat = lay.cu_k[s] + k0
                keys = torch.arange(k0, k0 + 128)
                sc = (qt @ kz[kat:kat + 128, h].T) * scale
                mask = (keys[None] >= sk) | (rows[:, None] >= sq)
                if causal:
                    mask |= keys[None] > rows[:, None] + off
                sc = torch.where(mask, -float("inf"), sc)
                mnew = torch.maximum(m, sc.amax(1))
                alpha = torch.exp(m - mnew)
                pr = torch.exp(sc - mnew[:, None])
                l = l * alpha + pr.sum(1)
                if p > 0:
                    pr = torch.where(tpo.keep_mask(
                        seed, h, lay.start_q[s] + rows[:, None],
                        lay.start_k[s] + keys[None], p), pr, 0.0)
                acc = acc * alpha[:, None] + pr @ vz[kat:kat + 128, h]
                m = mnew
            inv = (1.0 / (1.0 - p) if p > 0 else 1.0) / torch.where(
                l == 0, 1.0, l)
            keep = rows < sq
            out[lay.cu_q[s] + rows[keep], h] = (acc * inv[:, None])[keep]
            lse[h, lay.cu_q[s] + rows[keep]] = torch.where(
                l == 0, -1e30, m + torch.log(l))[keep]
            stores[lay.cu_q[s] + rows[keep], h] += 1
    return out, lse, stores


@functools.lru_cache(maxsize=None)
def _unit_case(name):
    lens_q, lens_k, causal, p, block = UNIT_CASES[name]
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    rng = np.random.RandomState(sum(lens_q) + 3 * sum(lens_k))
    q = rng.randn(cu_q[-1], H, D).astype(np.float32)
    k, v = (rng.randn(cu_k[-1], H, D).astype(np.float32) for _ in range(2))
    f = jax.jit(lambda q_, k_, v_: jpo.mha_packed(
        q_, k_, v_, jnp.asarray(cu_q), jnp.asarray(cu_k), causal=causal,
        dropout_p=p, seed=_jseed(SEED), block_q=block, block_k=block,
        interpret=True))
    return q, k, v, cu_q, cu_k, np.asarray(f(q, k, v))


@pytest.mark.parametrize("name", list(UNIT_CASES))
def test_wgmma_forward_unit_model_matches_jax_interpret(name):
    """The model of the wgmma packed forward's walk (above) gives the JAX
    ``_pk_fwd_kernel``'s out (interpret mode, f32) within 2e-5, the JAX
    package's tolerance, and the plain version's lse; every (row, head)
    of every sequence is stored exactly once."""
    lens_q, lens_k, causal, p, block = UNIT_CASES[name]
    q, k, v, cu_q, cu_k, want = _unit_case(name)
    lay = tpo.PackedLayout(cu_q, cu_k, len(q), len(k), block_q=block,
                           block_k=block)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse, stores = _wg_packed_forward_model(tq, tk, tv, lay, causal, p,
                                                SEED, D ** -0.5)
    assert torch.all(stores == 1)
    np.testing.assert_allclose(out.numpy(), want, atol=OUT_TOL, rtol=OUT_TOL)
    _, lse_ref = tpo.mha_packed_reference(
        tq, tk, tv, cu_q, cu_k, causal=causal, dropout_p=p, seed=SEED,
        block_q=block, block_k=block)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=OUT_TOL,
                               rtol=OUT_TOL)
    # the 129 rows whose sequence has no key: out 0, lse -1e30
    rows = slice(cu_q[2], cu_q[3])
    assert torch.all(out[rows] == 0) and torch.all(lse[:, rows] == -1e30)


# -- (c) F.flash_attn_unpadded ----------------------------------------------

@pytest.mark.parametrize("name", ["self-causal-default", "cross-full-default"])
def test_flash_attn_unpadded_matches_jax(name):
    lens_q, lens_k, causal, _, _ = CASES[name]
    c = _case(name)
    lens_k = lens_q if lens_k is None else lens_k
    scale = 0.25
    jout, none = jfa.flash_attn_unpadded(
        *(pt.to_tensor(c[n]) for n in ("q", "k", "v", "cu_q", "cu_k")),
        max(lens_q), max(lens_k), scale, causal=causal)
    assert none is None
    ts = [torch.from_numpy(c[n]).requires_grad_() for n in ("q", "k", "v")]
    out, none = F.flash_attn_unpadded(
        *ts, torch.from_numpy(c["cu_q"]), torch.from_numpy(c["cu_k"]),
        max(lens_q), max(lens_k), scale, causal=causal)
    assert none is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout._data),
                               atol=OUT_TOL, rtol=OUT_TOL)
    # the gradient through the port's autograd against jax.grad of the
    # JAX entry's kernel call (D = 32: scale 1 / sqrt(32) is not 0.25)
    jgrads = jax.grad(lambda *a: jnp.sum(jpo.mha_packed(
        *a, jnp.asarray(c["cu_q"]), jnp.asarray(c["cu_k"]), causal=causal,
        sm_scale=scale, interpret=True) * c["w"]), argnums=(0, 1, 2))(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v")))
    (out * torch.from_numpy(c["w"])).sum().backward()
    for t, want, what in zip(ts, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=what)


@pytest.mark.parametrize("cu,total,max_len", [
    ([1, 5, 9], 9, 8),          # a bad start
    ([0, 6, 4, 9], 9, 8),       # a decrease
    ([0, 4, 8], 9, 8),          # a wrong end
    ([0, 2, 9], 9, 6),          # max_seqlen below the longest sequence
], ids=["start", "decrease", "end", "max_seqlen"])
def test_validate_cu_refusals_carry_the_jax_messages(cu, total, max_len):
    with pytest.raises(ValueError) as jerr:
        jfa._validate_cu(jnp.asarray(cu, jnp.int32), total, "cu_seqlens_q",
                         max_len)
    x = torch.zeros(total, H, D)
    good = torch.tensor([0, total], dtype=torch.int32)
    with pytest.raises(ValueError) as terr:
        F.flash_attn_unpadded(x, x, x, torch.tensor(cu, dtype=torch.int32),
                              good, max_len, total, 0.25)
    assert str(terr.value) == str(jerr.value)


def test_flash_attn_unpadded_dropout_draws_from_the_generator():
    c = _case("self-causal-default")
    q, k, v = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
    args = (c["cu_q"], c["cu_k"], 33, 33, 0.25, 0.1, True)
    with pytest.raises(ValueError, match="generator"):
        F.flash_attn_unpadded(q, k, v, *args)
    a, _ = F.flash_attn_unpadded(q, k, v, *args,
                                 generator=make_generator(3, "cpu"))
    b, _ = F.flash_attn_unpadded(q, k, v, *args,
                                 generator=make_generator(3, "cpu"))
    plain, _ = F.flash_attn_unpadded(q, k, v, *args, training=False)
    assert torch.equal(a, b) and not torch.equal(a, plain)


# -- (d) dispatch: CPU -> plain versions, CUDA -> kernels, never both --------

def _forbid(*a, **k):
    raise AssertionError("reached where it must not")


def _fake_packed_launches(monkeypatch, calls):
    def fwd(q, k, v, seed, causal, sm_scale, dropout_p, layout=None, *rest):
        calls.append(("fwd", layout is not None))
        return (torch.empty(q.shape, device="meta"),
                torch.empty((q.shape[1], q.shape[0]), device="meta"))

    def dq(q, *a):
        calls.append(("dq", a[-1] is not None))
        return torch.empty(q.shape, device="meta")

    def dkv(q, k, *a):
        calls.append(("dkv", a[-1] is not None))
        return (torch.empty(k.shape, device="meta"),
                torch.empty(k.shape, device="meta"))

    monkeypatch.setattr(tpo, "_launch_fwd", fwd)
    monkeypatch.setattr(tpo, "_launch_dq", dq)
    monkeypatch.setattr(tpo, "_launch_dkv", dkv)
    for name in ("mha_packed_reference", "mha_packed_dq_reference",
                 "mha_packed_dkv_reference", "mha_reference",
                 "mha_dq_reference", "mha_dkv_reference"):
        monkeypatch.setattr(tpo, name, _forbid)


class _FakeCuda(types.SimpleNamespace):
    """Stands in for a CUDA tensor: only ``device`` and ``shape`` are
    read before the dispatch decision."""


def test_cuda_tensor_reaches_each_packed_kernel_never_its_plain_version(
        monkeypatch):
    calls = []
    _fake_packed_launches(monkeypatch, calls)
    reset_launch_counts()
    q = _FakeCuda(device=torch.device("cuda", 0), shape=(73, H, D))
    lay = tpo.PackedLayout([0, 40, 73], [0, 40, 73], 73, 73)
    tpo.flash_packed_fwd(q, q, q, lay, causal=True)
    tpo.flash_packed_bwd_dq(q, q, q, q, None, None, lay, causal=True)
    tpo.flash_packed_bwd_dkv(q, q, q, q, None, None, lay, causal=True)
    assert calls == [("fwd", True), ("dq", True), ("dkv", True)]
    assert {n: KERNELS[n].launches for n in PACKED + FIXED} == {
        **{n: 1 for n in PACKED}, **{n: 0 for n in FIXED}}


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["nodrop", "drop0.1"])
def test_card_tensor_through_flash_attn_unpadded_reaches_the_packed_kernels(
        monkeypatch, dropout):
    # a meta tensor stands in for a card tensor: it is not on the CPU
    calls = []
    _fake_packed_launches(monkeypatch, calls)
    gen = object()     # the run's generator, handed to draw_seed
    monkeypatch.setattr(tpo, "draw_seed", lambda g: (
        calls.append("seed") if g is gen else _forbid()) or torch.zeros(
            (), dtype=torch.int32, device="meta"))
    reset_launch_counts()
    x = torch.zeros(73, H, D, device="meta", requires_grad=True)
    cu = torch.tensor([0, 40, 40, 73], dtype=torch.int32)
    out, _ = F.flash_attn_unpadded(x, x, x, cu, cu, 40, 40, 0.25,
                                   dropout=dropout, causal=True,
                                   generator=gen)
    seeded = ["seed"] if dropout else []
    assert out.shape == x.shape and calls == seeded + [("fwd", True)]
    out.sum().backward()
    assert calls == seeded + [("fwd", True), ("dq", True), ("dkv", True)]
    assert {n: KERNELS[n].launches for n in PACKED + FIXED} == {
        **{n: 1 for n in PACKED}, **{n: 0 for n in FIXED}}


def test_cpu_tensor_never_reaches_a_launch(monkeypatch):
    calls = []

    def counting(name):
        fn = getattr(tpo, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for name in ("mha_packed_reference", "mha_packed_dq_reference",
                 "mha_packed_dkv_reference"):
        monkeypatch.setattr(tpo, name, counting(name))
    for name in ("_launch_fwd", "_launch_dq", "_launch_dkv"):
        monkeypatch.setattr(tpo, name, _forbid)
    reset_launch_counts()
    c = _case("self-causal-default")
    ts = [torch.from_numpy(c[n]).requires_grad_() for n in ("q", "k", "v")]
    tpo.mha_packed(*ts, c["cu_q"], c["cu_k"], causal=True).sum().backward()
    assert calls == ["mha_packed_reference", "mha_packed_dq_reference",
                     "mha_packed_dkv_reference"]
    assert all(KERNELS[n].launches == 0 for n in PACKED)


def test_kernel_registry_holds_every_pallas_call_site():
    # 15 pallas_call sites in the JAX package, 15 wrappers in the port
    assert len(KERNELS) == 15
    assert all(KERNELS[n] is getattr(tpo, n) for n in PACKED)
    for n in PACKED:
        KERNELS[n].launches = 3
    reset_launch_counts()
    assert all(KERNELS[n].launches == 0 for n in KERNELS)


def test_packed_wrappers_take_only_cpu_or_cuda():
    x = torch.zeros(73, H, D, device="meta")
    stats = torch.zeros(H, 73, device="meta")
    lay = tpo.PackedLayout([0, 73], [0, 73], 73, 73)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tpo.flash_packed_fwd(x, x, x, lay, causal=True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tpo.flash_packed_bwd_dq(x, x, x, x, stats, stats, lay)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tpo.flash_packed_bwd_dkv(x, x, x, x, stats, stats, lay)
