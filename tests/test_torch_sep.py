"""Sequence parallelism in the port (ring and Ulysses attention, GPT's sep
step), on the CPU over gloo ranks, held to the JAX package and to the
world of one.

 - ``ring_attention`` and ``ulysses_attention`` at sep 2 and 4 (one
   spawn a degree), causal and not: each rank's output shard and its
   q, k and v gradients (loss ``sum(o sin o)``) against the JAX functions
   under ``shard_map`` on the 8-device CPU mesh, on the same numpy
   inputs, within ``ATTN_TOL`` (``tests/test_sequence_parallel.py``'s).
 - Both at attention dropout ``DROPOUT`` with one seed against the
   port's flash attention (``pallas_ops.mha``, its plain versions here)
   over the whole sequence with that seed: the ring's hash base places
   each block's mask in the whole attention's, Ulysses' its heads.
 - The ring with its fully masked causal blocks skipped and computed:
   the same bits; a masked block's merge weight is exactly 0 and its
   gradients exactly 0, with its own lse of -1e30 too.
 - ``fleet.init`` with ``sep_degree`` builds the sep and ``data x sep``
   groups; sep with pp raises by name; the CLI's ``--sep``.
 - ``gpt_tiny`` in f32 without dropout, three ``AdamW(1e-3)`` steps
   with a clip that bites, at sep 2, dp 2 x sep 2, mp 2 x sharding 2 x
   sep 2 at ``os_g`` (eight ranks) and sharding 2 x sep 2 at every ZeRO
   level, against the world of one on the
   same weights (``params_from_numpy``): losses within ``LOSS_TOL``, the
   clip's norm within ``NORM_RTOL`` (each sep-replicated gradient
   counted once), the gathered weights within ``WEIGHT_TOL``.
 - ``local_batch`` over dp x sharding x sep at once.
 - Packed varlen attention with the heads split over 2 sep ranks (the
   dryrun's lengths 24, 40, 16), output and gradients within
   ``PACKED_TOL`` of the whole run's head slice.

Each spawn is bounded by ``SPAWN_TIMEOUT`` seconds and uses a file store
under the test's temporary directory.  The ranks' functions import
neither JAX nor the JAX package.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import fleet, spawn
from paddle_tpu_torch.incubate.models import gpt_tiny
from paddle_tpu_torch.ops import pallas_ops as tpo
from test_torch_zero import (CLIP, LEVELS, NO_DROPOUT, _optimizer,
                             gathered, load_arrays, rank_result, run_steps)

SPAWN_TIMEOUT = 90
ATTN_TOL = 2e-4
LOSS_TOL = 1e-5
NORM_RTOL = 1e-5
WEIGHT_TOL = 2e-4
PACKED_TOL = 1e-5
B, H, S, D = 2, 4, 64, 16
DROPOUT, SEED = 0.1, 1234
DEGREES = (2, 4)
KINDS = ("ring", "ulysses")
PACKED_LENS = (24, 40, 16)
# dp, mp, sharding, sep of each GPT mesh
GPT_MESHES = {"sep2": (1, 1, 1, 2), "dp2xsep2": (2, 1, 1, 2),
              "mp2xsh2xsep2": (1, 2, 2, 2)}
GPT_B, GPT_S = 4, 64


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal((B, H, S, D)).astype(np.float32)
                 for _ in range(3))


def _loss(o):
    return (o * torch.sin(o)).sum()


def _run_attention(fn, arrays, **kw):
    """``fn`` on leaf tensors of ``arrays``: the output and q, k, v
    gradients, as numpy."""
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
               for a in arrays)
    o = fn(q, k, v, **kw)
    _loss(o).backward()
    return [t.detach().numpy().copy() for t in (o, q.grad, k.grad, v.grad)]


def _packed_data():
    rng = np.random.RandomState(7)
    total = sum(PACKED_LENS)
    cu = np.concatenate([[0], np.cumsum(PACKED_LENS)]).astype(np.int32)
    return cu, tuple(rng.standard_normal((total, H, D)).astype(np.float32)
                     for _ in range(3))


def _run_packed(arrays, cu):
    return _run_attention(
        lambda q, k, v: tpo.mha_packed(q, k, v, cu, cu, causal=True),
        arrays)


# -- the attention functions (one spawn a degree) ------------------------------

def _attn_rank(n, arrays, packed):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        gather_sequence, ring_attention, split_sequence, ulysses_attention)
    from paddle_tpu_torch.train import build_train_step
    tdist.init_parallel_env(device="cpu")
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"sep_degree": n}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    r = hcg.get_sep_parallel_rank()
    sl = S // n
    mine = [a[:, :, r * sl:(r + 1) * sl] for a in arrays]
    res = {"rank": r, "sep": hcg.get_sep_parallel_world_size(),
           "sep_ranks": hcg.get_sep_parallel_group().ranks,
           "dp_sep_ranks": hcg.get_dp_sep_parallel_group().ranks,
           "mode": hcg.get_parallel_mode()}
    # a replicated (B, S, D) tensor cut to the shard and gathered back;
    # every rank takes the same loss of the gathered tensor, so the
    # shard's gradient is n times its slice of the weights
    x = torch.from_numpy(arrays[0][:, 0]).requires_grad_()
    part = split_sequence(x)
    whole = gather_sequence(part)
    (whole * torch.from_numpy(arrays[1][:, 0])).sum().backward()
    res["split"] = (part.detach().numpy().copy(),
                    whole.detach().numpy().copy(), x.grad.numpy().copy())
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    for kind, fn in fns.items():
        for causal in (False, True):
            for p in (0.0, DROPOUT):
                res[kind, causal, p] = _run_attention(
                    fn, mine, causal=causal, dropout_p=p, seed=SEED)
    for p in (0.0, DROPOUT):
        res["computed", p] = _run_attention(
            ring_attention, mine, causal=True, dropout_p=p, seed=SEED,
            skip_masked=False)
    if n == 2:
        cu, arrs = packed
        hn = H // n
        res["packed"] = _run_packed([a[:, r * hn:(r + 1) * hn] for a in arrs],
                                    cu)
    else:
        try:
            build_train_step(gpt_tiny(), device="cpu", amp_o2=False, pp=2,
                             sep=2, capture=False)
        except NotImplementedError as e:
            res["sep_pp"] = str(e)
    # no rank leaves while a peer still connects to the last groups made
    tdist.barrier()
    return res


_ATTN = {}


@pytest.fixture(scope="module")
def attn_runs(tmp_path_factory):
    def get(n):
        if n not in _ATTN:
            root = tmp_path_factory.mktemp(f"sep{n}")
            _ATTN[n] = spawn(_attn_rank, args=(n, _qkv(), _packed_data()),
                             nprocs=n, store=str(root / "store"),
                             timeout=SPAWN_TIMEOUT)
        return _ATTN[n]
    yield get
    _ATTN.clear()


def _whole(ranks, key):
    """The ranks' shards of ``key`` (output, dq, dk, dv) along the
    sequence, whole."""
    ranks = sorted(ranks, key=lambda r: r["rank"])
    return [np.concatenate([r[key][i] for r in ranks], axis=2)
            for i in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_attention(kind, n, causal):
    """The JAX function under shard_map over ``n`` CPU devices: output
    and q, k, v gradients of ``sum(o sin o)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.distributed._jax_compat import shard_map
    from paddle_tpu.distributed.fleet.meta_parallel import \
        sequence_parallel as jsp
    fn = {"ring": jsp.ring_attention, "ulysses": jsp.ulysses_attention}[kind]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("sep",))
    spec = P(None, None, "sep", None)

    def run(q, k, v):
        return shard_map(lambda a, b, c: fn(a, b, c, axis_name="sep",
                                            causal=causal),
                         mesh=mesh, in_specs=spec, out_specs=spec)(q, k, v)

    def loss(q, k, v):
        o = run(q, k, v)
        return jnp.sum(o * jnp.sin(o))

    q, k, v = (jnp.asarray(a) for a in _qkv())
    out = jax.jit(run)(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _close(got, want, tol, what):
    for g, w, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", DEGREES)
def test_sep_attention_matches_the_jax_function(attn_runs, n, kind, causal):
    got = _whole(attn_runs(n), (kind, causal, 0.0))
    _close(got, _jax_attention(kind, n, causal), ATTN_TOL, f"{kind} sep {n}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", DEGREES)
def test_sep_attention_dropout_is_the_whole_attentions_mask(attn_runs, n,
                                                            kind, causal):
    got = _whole(attn_runs(n), (kind, causal, DROPOUT))
    want = _run_attention(tpo.mha, _qkv(), causal=causal, dropout_p=DROPOUT,
                          seed=SEED)
    _close(got, want, ATTN_TOL, f"{kind} sep {n} dropout")
    # dropout bites: the same run without it differs
    plain = _whole(attn_runs(n), (kind, causal, 0.0))
    assert np.abs(got[0] - plain[0]).max() > 10 * ATTN_TOL


@pytest.mark.parametrize("p", [0.0, DROPOUT], ids=["nodrop", "drop"])
@pytest.mark.parametrize("n", DEGREES)
def test_skipped_masked_blocks_give_the_computed_bits(attn_runs, n, p):
    for r in attn_runs(n):
        for got, want in zip(r["ring", True, p], r["computed", p]):
            np.testing.assert_array_equal(got, want)


def test_masked_block_has_merge_weight_zero_and_zero_gradients():
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sequence_parallel \
        import _merge
    q, k, v = (torch.from_numpy(a[:, :, :S // 2]).transpose(1, 2)
               for a in _qkv())
    shift = torch.tensor(-S // 2, dtype=torch.int32)
    o1, lse1 = tpo.flash_fwd(q, k, v, causal=True)
    o2, lse2 = tpo.flash_fwd(q, k, v, causal=True, causal_shift=shift)
    assert torch.all(lse2 == -1e30) and torch.all(o2 == 0)
    o, lse = _merge(o1.float(), lse1, o2.float(), lse2)
    assert torch.equal(o, o1.float()) and torch.equal(lse, lse1)
    do = torch.randn(q.shape)
    for stats in (lse1, lse2):   # the merged lse, and the block's own
        delta = tpo._delta(o1, do)
        dq = tpo.flash_bwd_dq(q, k, v, do, stats, delta, causal=True,
                              causal_shift=shift)
        dk, dv = tpo.flash_bwd_dkv(q, k, v, do, stats, delta, causal=True,
                                   causal_shift=shift)
        for g in (dq, dk, dv):
            assert torch.count_nonzero(g) == 0


@pytest.mark.parametrize("n", DEGREES)
def test_fleet_init_with_sep_builds_the_groups(attn_runs, n):
    ranks = attn_runs(n)
    assert sorted(r["rank"] for r in ranks) == list(range(n))
    for r in ranks:
        assert r["sep"] == n and r["sep_ranks"] == list(range(n))
        assert r["dp_sep_ranks"] == list(range(n))
        assert r["mode"] == "data"
    if n == 4:
        assert all("sep_degree 2 with pp_degree 2" in r["sep_pp"]
                   for r in ranks)


@pytest.mark.parametrize("n", DEGREES)
def test_split_and_gather_sequence(attn_runs, n):
    x, w = (a[:, 0] for a in _qkv()[:2])          # (B, S, D)
    sl = S // n
    for r in attn_runs(n):
        part, whole, grad = r["split"]
        mine = slice(r["rank"] * sl, (r["rank"] + 1) * sl)
        np.testing.assert_array_equal(part, x[:, mine])
        np.testing.assert_array_equal(whole, x)
        want = np.zeros_like(x)
        want[:, mine] = n * w[:, mine]
        np.testing.assert_allclose(grad, want, rtol=1e-6, atol=1e-6)


def test_packed_varlen_with_heads_split_over_sep_matches_the_whole_run(
        attn_runs):
    cu, arrays = _packed_data()
    want = _run_packed(arrays, cu)
    hn = H // 2
    for r in attn_runs(2):
        h = slice(r["rank"] * hn, (r["rank"] + 1) * hn)
        for got, w, name in zip(r["packed"], want, ("out", "dq", "dk", "dv")):
            np.testing.assert_allclose(got, w[:, h], atol=PACKED_TOL,
                                       rtol=PACKED_TOL, err_msg=name)


def test_ring_of_one_is_flash_attention_and_ulysses_checks_heads():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        RingFlashAttention, ring_attention, ulysses_attention)
    arrays = _qkv()
    for causal in (False, True):
        got = _run_attention(ring_attention, arrays, causal=causal)
        want = _run_attention(tpo.mha, arrays, causal=causal)
        _close(got, want, 1e-6, "ring of one")
    x = torch.from_numpy(arrays[0]).transpose(1, 2)
    out = RingFlashAttention(causal=True)(x, x, x)
    from paddle_tpu_torch.nn import functional as F
    torch.testing.assert_close(out, F.scaled_dot_product_attention(
        x, x, x, is_causal=True))

    class Three:
        nranks, rank = 3, 0

    with pytest.raises(ValueError, match="heads 4 not divisible by sep "
                                         "degree 3"):
        ulysses_attention(*(torch.from_numpy(a) for a in arrays),
                          group=Three())


# -- GPT's sep step against the world of one ---------------------------------------

def _gpt_batch():
    rng = np.random.RandomState(11)
    return (rng.randint(0, 1024, (GPT_B, GPT_S)).astype(np.int64),
            rng.randint(0, 1024, (GPT_B, GPT_S)).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _world_of_one():
    from paddle_tpu_torch.train import build_train_step
    step = build_train_step(gpt_tiny(**NO_DROPOUT), device="cpu",
                            amp_o2=False, fusion=False,
                            optimizer=_optimizer())
    init = {n: p.detach().numpy().copy() for n, p in step.params.items()}
    losses, norms = run_steps(step, _gpt_batch())
    return {"init": init, "losses": losses, "norms": norms,
            "params": {n: p.detach().numpy().copy()
                       for n, p in step.params.items()}}


def _gpt_rank(arrays, batch, dims):
    from paddle_tpu_torch.distributed.sharding import MIN_SIZE, state_bytes
    from paddle_tpu_torch.train import build_train_step
    dp, mp, sh, sep = dims
    tdist.init_parallel_env(device="cpu")
    step = build_train_step(gpt_tiny(**NO_DROPOUT), device="cpu",
                            amp_o2=False, dp=dp, mp=mp, sharding=sh, sep=sep,
                            sharding_level="os_g" if sh > 1 else None,
                            capture=False, optimizer=_optimizer())
    load_arrays(step, arrays)
    res = rank_result(step, *run_steps(step, batch))
    hcg = step.hcg
    res["sep_rank"] = hcg.get_sep_parallel_rank()
    big = [n for n, p in step.params.items() if p.numel() >= MIN_SIZE]
    own = sum(step.params[n].numel() * 4 * 2 for n in big)
    res["state_share"] = state_bytes(step.state, big) / own
    return res


_GPT = {}


@pytest.fixture(scope="module")
def gpt_runs(tmp_path_factory):
    def get(mesh):
        if mesh not in _GPT:
            dims = GPT_MESHES[mesh]
            root = tmp_path_factory.mktemp(mesh)
            _GPT[mesh] = spawn(
                _gpt_rank, args=(_world_of_one()["init"], _gpt_batch(), dims),
                nprocs=int(np.prod(dims)), store=str(root / "store"),
                timeout=SPAWN_TIMEOUT)
        return _GPT[mesh]
    yield get
    _GPT.clear()


@pytest.mark.parametrize("mesh", list(GPT_MESHES))
def test_gpt_sep_step_matches_the_world_of_one(gpt_runs, mesh):
    ref = _world_of_one()
    ranks = gpt_runs(mesh)
    assert ref["norms"][0] > 2 * CLIP                     # the clip bites
    assert sorted({r["sep_rank"] for r in ranks}) == [0, 1]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["norms"], ref["norms"], rtol=NORM_RTOL)
        if GPT_MESHES[mesh][2] > 1:
            assert r["state_share"] <= 0.55, r["state_share"]
    full = gathered(ranks)
    for name, want in ref["params"].items():
        np.testing.assert_allclose(full[name], want, atol=WEIGHT_TOL,
                                   rtol=WEIGHT_TOL, err_msg=name)


def _levels_rank(arrays, batch):
    """sharding 2 x sep 2 at each ZeRO level, one rank."""
    from paddle_tpu_torch.train import build_train_step
    tdist.init_parallel_env(device="cpu")
    out = {}
    for level in LEVELS:
        step = build_train_step(gpt_tiny(**NO_DROPOUT), device="cpu",
                                amp_o2=False, sharding=2, sep=2,
                                sharding_level=level, capture=False,
                                optimizer=_optimizer())
        load_arrays(step, arrays)
        out[level] = rank_result(step, *run_steps(step, batch))
        out[level]["level"] = step.zero.level
    return out


@pytest.fixture(scope="module")
def level_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("levels")
    return spawn(_levels_rank, args=(_world_of_one()["init"], _gpt_batch()),
                 nprocs=4, store=str(root / "store"), timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("level", LEVELS)
def test_gpt_sep_step_at_every_zero_level_matches_the_world_of_one(
        level_runs, level):
    ref = _world_of_one()
    ranks = [r[level] for r in level_runs]
    assert all(r["level"] == level for r in ranks)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["norms"], ref["norms"], rtol=NORM_RTOL)
    full = gathered(ranks)
    for name, want in ref["params"].items():
        np.testing.assert_allclose(full[name], want, atol=WEIGHT_TOL,
                                   rtol=WEIGHT_TOL, err_msg=name)


class _Hcg:
    """The coordinates ``local_batch`` reads."""

    def __init__(self, dp, sh, sep, coords):
        self.dims, (self.d, self.s, self.q) = (dp, sh, sep), coords

    def get_data_parallel_world_size(self):
        return self.dims[0]

    def get_sharding_parallel_world_size(self):
        return self.dims[1]

    def get_sep_parallel_world_size(self):
        return self.dims[2]

    def get_data_parallel_rank(self):
        return self.d

    def get_sharding_parallel_rank(self):
        return self.s

    def get_sep_parallel_rank(self):
        return self.q


def test_local_batch_takes_rows_over_dp_x_sharding_and_positions_over_sep():
    from paddle_tpu_torch.distributed.sharding import local_batch
    batch = torch.arange(8 * 12).reshape(8, 12)
    seen = []
    for d in range(2):
        for sh in range(2):
            for q in range(3):
                part = local_batch({"ids": batch, "x": [batch]},
                                   _Hcg(2, 2, 3, (d, sh, q)))
                rows = (d * 2 + sh) * 2
                want = batch[rows:rows + 2, q * 4:(q + 1) * 4]
                assert torch.equal(part["ids"], want)
                assert torch.equal(part["x"][0], want)
                seen.append(part["ids"])
    assert torch.equal(torch.sort(torch.cat([t.reshape(-1) for t in seen]))
                       [0], batch.reshape(-1))
    with pytest.raises(ValueError, match="sep ranks"):
        local_batch(torch.zeros(8, 10), _Hcg(1, 1, 3, (0, 0, 0)))


def test_train_cli_spawns_sep_ranks(monkeypatch):
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.train import main
    bounded = distributed.spawn
    monkeypatch.setattr(distributed, "spawn", lambda *a, **kw: bounded(
        *a, timeout=SPAWN_TIMEOUT, **kw))
    assert main(["--model", "gpt_tiny", "--sep", "2", "--batch", "2",
                 "--seq", "32", "--steps", "2", "--device", "cpu"]) == 0


def test_sep_dropout_streams(tmp_path):
    """The attention stream is the same on both sep ranks (the ring's
    seed), the hidden-state stream differs; at sep 1 both are the run's
    generator."""
    a, b = spawn(_streams_rank, args=(), nprocs=2,
                 store=str(tmp_path / "store"), timeout=SPAWN_TIMEOUT)
    assert a["attn"] == b["attn"] and a["glob"] != b["glob"]
    assert a["attn_is_glob"] is False


def _streams_rank():
    from paddle_tpu_torch.distributed.fleet.meta_parallel.random import (
        GLOBAL_RNG, MODEL_PARALLEL_RNG, model_parallel_random_seed)
    from paddle_tpu_torch.framework.random import make_generator
    tdist.init_parallel_env(device="cpu")
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"sep_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    gen = make_generator(0, "cpu")
    torch.rand(5, generator=gen)          # the weights' draws
    tr = model_parallel_random_seed(0, generator=gen)
    glob, attn = tr.get(GLOBAL_RNG), tr.get(MODEL_PARALLEL_RNG)
    tdist.barrier()      # the peer may still be connecting to the groups
    return {"glob": torch.rand(4, generator=glob).tolist(),
            "attn": torch.rand(4, generator=attn).tolist(),
            "attn_is_glob": attn is glob}


def test_gpt_positions_start_at_the_sep_ranks_offset():
    """Without fleet the embeddings start at 0; a sep rank's at its
    shard's first position (the attribute the model reads)."""
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.incubate.models import GPTForCausalLM
    cfg = dataclasses.replace(gpt_tiny(**NO_DROPOUT), num_layers=1)
    model = GPTForCausalLM(cfg, generator=make_generator(0, "cpu"))
    emb = model.gpt.embeddings
    ids = torch.arange(8)[None, :]
    base = emb(ids)
    emb.sep_rank = 1
    shifted = emb(ids)
    w = emb.position_embeddings.weight.detach()
    torch.testing.assert_close((shifted - base)[0], w[8:16] - w[:8])
    assert model.gpt.layers[0].attn.ring is None


@pytest.mark.parametrize("base", [(0, 0, 0, 0), (0, 0, 0, H)],
                         ids=["zeros", "heads"])
def test_zero_hash_base_keeps_the_call_s_own_mask(base):
    """Rows 1-3's plain versions at a zero hash base: the mask and the
    outputs of a call without one, bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    seed = torch.tensor(99, dtype=torch.int32)
    _, old = tpo._fixed_masks(q, k, True, DROPOUT, seed, None, None)
    _, new = tpo._fixed_masks(q, k, True, DROPOUT, seed, None, None, base)
    assert torch.equal(old, tpo._keep(
        seed, DROPOUT, torch.arange(B * H).reshape(B, H, 1, 1), 0, 0, S, S,
        "cpu")) and torch.equal(old, new)
    a = tpo.mha_reference(q, k, v, causal=True, dropout_p=DROPOUT, seed=seed)
    b = tpo.mha_reference(q, k, v, causal=True, dropout_p=DROPOUT, seed=seed,
                          hash_base=base)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("r0,c0,h0", [(32, 0, 0), (16, 48, 2), (0, 32, 1)])
def test_a_block_with_its_hash_base_draws_its_slice_of_the_mask(r0, c0, h0):
    q, k, _ = (torch.from_numpy(a) for a in _qkv())
    seed = torch.tensor(7, dtype=torch.int32)
    _, whole = tpo._fixed_masks(q, k, False, DROPOUT, seed, None, None)
    hb, sq, sk = 2, 16, 16
    qb = q[:, h0:h0 + hb, r0:r0 + sq]
    kb = k[:, h0:h0 + hb, c0:c0 + sk]
    _, block = tpo._fixed_masks(qb, kb, False, DROPOUT, seed, None, None,
                                (r0, c0, h0, H))
    assert torch.equal(block, whole[:, h0:h0 + hb, r0:r0 + sq, c0:c0 + sk])
