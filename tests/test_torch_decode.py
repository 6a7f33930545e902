"""PyTorch port vs JAX reference: KV caches, cached prefill and
single-token decode, on the CPU at the reduced configurations.

Inputs are made with numpy from a seed and handed to both; weights cross
through ``convert.model_params_from_numpy``, a reference cache through
``convert.cache_from_numpy``.  Tolerances, relative to the reference's
largest |value|: attention and ``sdpa_blockwise`` 2e-5 (another summation
order), the SSM mixer 1e-5, whole-model logits 1e-4 (two layers of float32
matmuls in another order).  Caches are float32 for parity; the bfloat16
default is held to its rounding (below).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from _torch_serve_cases import models, numpy_tree, rel, t, tokens  # noqa: E402

MODEL_ARCHS = ["tinyllama-1.1b", "internlm2-1.8b", "phi4-mini-3.8b", "gemma2-9b",
               "mamba2-780m"]


def _cfgs(name, **kw):
    """(reference cfg, port cfg), reduced, with ``kw`` replaced in both."""
    return (dataclasses.replace(jcfg.get(name, reduced=True), **kw),
            dataclasses.replace(tcfg.get(name, reduced=True), **kw))


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    shapes = tattn.param_shapes(cfg)
    return {k: (rng.standard_normal(s) / np.sqrt(s[1] * s[2] if k == "wo" else s[0]))
            .astype(np.float32) for k, s in shapes.items()}


def _pos(B, start, S):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).astype(np.int32)


def _attn_run(name, window, S, steps, max_len, dtype, seed=0):
    """The reference's and the port's attention.apply over a prefill of S
    tokens and ``steps`` single-token decodes into one cache: (outputs,
    final caches) of each."""
    jc, tc = _cfgs(name)
    p = _attn_params(tc, seed)
    rng = np.random.default_rng(seed + 1)
    B, d = 2, tc.d_model
    xs = [rng.standard_normal((B, S, d)).astype(np.float32)]
    xs += [rng.standard_normal((B, 1, d)).astype(np.float32) for _ in range(steps)]
    jp = jattn.AttnParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: t(v) for k, v in p.items()}
    jcache = jattn.init_cache(jc, B, max_len, dtype=jnp.bfloat16 if dtype == "bf16"
                              else jnp.float32)
    tcache = tattn.init_cache(tc, B, max_len, dtype=torch.bfloat16 if dtype == "bf16"
                              else torch.float32, device="cpu")
    jout, tout, at = [], [], 0
    for x in xs:
        s = x.shape[1]
        o, jcache = jattn.apply(jp, jc, jnp.asarray(x), positions=jnp.asarray(_pos(B, at, s)),
                                window=window, cache=jcache, cache_index=jnp.int32(at))
        jout.append(np.asarray(o))
        o, tcache = tattn.apply(tp, tc, t(x), positions=torch.from_numpy(
            _pos(B, at, s).astype(np.int64)), window=window, cache=tcache, cache_index=at)
        tout.append(o.numpy())
        at += s
    return jout, tout, jcache, tcache


@pytest.mark.parametrize("name,window", [
    ("internlm2-1.8b", None),
    ("internlm2-1.8b", 16),        # a window shorter than the sequence
    ("gemma2-9b", 16),             # soft-capped logits, windowed
    ("gemma2-9b", None),           # soft-capped logits, global
])
def test_attention_cached_prefill_and_decode_match_reference(name, window):
    jout, tout, jcache, tcache = _attn_run(name, window, S=40, steps=3, max_len=48,
                                           dtype="f32")
    for got, want in zip(tout, jout):
        assert rel(got, want) <= 2e-5
    for got, want in zip(tcache, jcache):
        assert rel(got.numpy(), np.asarray(want)) <= 2e-5


def test_attention_bf16_cache_rounds_on_write():
    """The default bfloat16 cache: each row written is the float32 row
    rounded to bfloat16, and attention reads the rounded rows back as
    float32.  Against the reference's own bfloat16 run the outputs agree to
    bfloat16's rounding (2**-8 relative on K and V, 1e-2 on the output);
    the float32 parity is the test above."""
    jout, tout, jcache, tcache = _attn_run("internlm2-1.8b", 16, S=40, steps=2,
                                           max_len=48, dtype="bf16")
    _, t32, _, c32 = _attn_run("internlm2-1.8b", 16, S=40, steps=2, max_len=48,
                               dtype="f32")
    for got, f32 in zip(tcache, c32):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, f32.to(torch.bfloat16))
    for got, want in zip(tout, jout):
        assert rel(got, want) <= 1e-2


@pytest.mark.parametrize("softcap,window,kv_len,causal", [
    (None, None, None, True),
    (50.0, None, None, True),      # soft-capped
    (None, 24, None, True),        # windowed
    (50.0, 24, (37, 21), True),    # everything, and a valid prefix per row
    (None, None, (40, 29), False), # bidirectional with kv_len
])
def test_sdpa_blockwise_matches_reference(softcap, window, kv_len, causal):
    """Skv = 40 over blocks of 16: the last block is padded (40 % 16 != 0)."""
    rng = np.random.default_rng(7)
    B, Sq, Skv, H, KV, hd = 2, 40, 40, 4, 2, 32
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    qpos = _pos(B, 0, Sq)
    kpos = np.arange(Skv)[None].astype(np.int32)
    kw = dict(causal=causal, window=window, softcap_val=softcap)
    jl = None if kv_len is None else jnp.asarray(kv_len, dtype=jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len)
    want = np.asarray(jattn.sdpa_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(qpos),
        kv_pos=jnp.asarray(kpos), kv_len=jl, block=16, **kw))
    tq, tk, tv = t(q), t(k), t(v)
    tqpos, tkpos = torch.from_numpy(qpos.astype(np.int64)), torch.from_numpy(
        kpos.astype(np.int64))
    got = tattn.sdpa_blockwise(tq, tk, tv, q_pos=tqpos, kv_pos=tkpos, kv_len=tl,
                               block=16, **kw)
    assert rel(got.numpy(), want) <= 2e-5
    naive = tattn.sdpa(tq, tk, tv, q_pos=tqpos, kv_pos=tkpos, kv_len=tl, **kw)
    assert rel(got.numpy(), naive.numpy()) <= 2e-5


def _ssm_params(cfg, seed):
    p = jssm.init(jax.random.PRNGKey(seed), cfg)
    return p, {k: t(v) for k, v in numpy_tree(p).items()}


@pytest.mark.parametrize("chunks", [
    (64, 2, 1, 1),      # prefill, then S = 2 < K - 1 from h0, then two decodes
    (32, 1, 1, 32),     # a decode, then a prefill of one chunk from h0
])
def test_ssm_cached_prefill_and_decode_match_reference(chunks):
    cfg = jcfg.get("mamba2-780m", reduced=True)
    tc = tcfg.get("mamba2-780m", reduced=True)
    jp, tp = _ssm_params(cfg, 3)
    rng = np.random.default_rng(4)
    B = 2
    jcache = jssm.init_cache(cfg, B, dtype=jnp.float32)
    tcache = tssm.init_cache(tc, B, dtype=torch.float32, device="cpu")
    for S in chunks:
        x = (0.5 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
        want, jcache = jssm.apply(jp, cfg, jnp.asarray(x), cache=jcache)
        got, tcache = tssm.apply(tp, tc, t(x), cache=tcache)
        assert rel(got.numpy(), want) <= 1e-5
        for g, w in zip(tcache, jcache):
            assert g.dtype == torch.float32
            assert rel(g.numpy(), np.asarray(w)) <= 1e-5


def test_ssm_conv_state_short_sequences():
    """``_causal_conv``'s new state when S < K - 1 reaches back into the old
    state, as the reference's; the SSM state stays float32 under a bfloat16
    conv state."""
    rng = np.random.default_rng(5)
    B, Cd, K = 2, 6, 4
    w = rng.standard_normal((Cd, K)).astype(np.float32)
    b = rng.standard_normal(Cd).astype(np.float32)
    state = rng.standard_normal((B, K - 1, Cd)).astype(np.float32)
    for S in (1, 2, 3, 5):
        seq = rng.standard_normal((B, S, Cd)).astype(np.float32)
        want_out, want_state = jssm._causal_conv(jnp.asarray(seq), jnp.asarray(w),
                                                 jnp.asarray(b), jnp.asarray(state))
        got_out, got_state = tssm._causal_conv(t(seq), t(w), t(b), t(state))
        assert rel(got_out.numpy(), want_out) <= 1e-6
        assert np.array_equal(got_state.numpy(), np.asarray(want_state))
    cache = tssm.init_cache(tcfg.get("mamba2-780m", reduced=True), 2, device="cpu")
    assert cache[0].dtype == torch.bfloat16 and cache[1].dtype == torch.float32


def _ref_decode(jm, params, cache, toks, at):
    logits, cache, _ = jm.apply(params, {"tokens": jnp.asarray(toks, dtype=jnp.int32)},
                                cache=cache, cache_index=jnp.int32(at))
    return np.asarray(logits), cache


@pytest.mark.parametrize("name", MODEL_ARCHS)
def test_model_cached_prefill_and_decode_match_reference(name):
    """Prefill S = 80 (past gemma2's reduced window of 64) and 4 decode steps;
    then the port's decode from the reference's prefilled cache."""
    jm, params, tm = models(name)
    B, S, steps, max_len = 2, 80, 4, 96
    prompt = tokens(tm.cfg.vocab, (B, S), seed=11)
    nxt = tokens(tm.cfg.vocab, (steps, B, 1), seed=12)
    jcache = jm.init_cache(B, max_len, dtype=jnp.float32)
    want, jcache = _ref_decode(jm, params, jcache, prompt, 0)
    prefilled = numpy_tree(jcache)
    tcache = tm.init_cache(B, max_len, dtype=torch.float32)
    ops.reset_launch_counts()
    got, tcache = tm.apply({"tokens": torch.from_numpy(prompt)}, cache=tcache,
                           cache_index=0)
    assert ops.launch_counts()["flash_attention"] == 0    # kv_len set: the plain path
    assert rel(got.numpy(), want) <= 1e-4
    assert rel(tm.apply({"tokens": torch.from_numpy(prompt)}).numpy(), want) <= 1e-4
    from_ref = convert.cache_from_numpy(tm.cfg, prefilled, device="cpu")
    for i in range(steps):
        want, jcache = _ref_decode(jm, params, jcache, nxt[i], S + i)
        got, tcache = tm.apply({"tokens": torch.from_numpy(nxt[i])}, cache=tcache,
                               cache_index=S + i)
        assert got.shape == (B, 1, tm.cfg.vocab)
        assert rel(got.numpy(), want) <= 1e-4
        got_ref, from_ref = tm.apply({"tokens": torch.from_numpy(nxt[i])}, cache=from_ref,
                                     cache_index=S + i)
        assert rel(got_ref.numpy(), want) <= 1e-4


@pytest.mark.parametrize("name", ["internlm2-1.8b", "gemma2-9b"])
def test_model_blockwise_matches_reference(name):
    """``attn_impl="blockwise"`` against the reference's blockwise model:
    the cache-less forward over S = 80 (past gemma2's reduced window of 64)
    and a cached prefill with 2 decode steps."""
    _, params, tm0 = models(name)
    jm = JModel(jcfg.get(name, reduced=True), attn_impl="blockwise")
    tm = ttr.make_model(name, reduced=True, attn_impl="blockwise", device="cpu")
    tm.load_state_dict(tm0.state_dict())
    B, S, max_len = 2, 80, 96
    prompt = tokens(tm.cfg.vocab, (B, S), seed=13)
    want = np.asarray(jm.apply(params, {"tokens": jnp.asarray(prompt, dtype=jnp.int32)})[0])
    assert rel(tm.apply({"tokens": torch.from_numpy(prompt)}).numpy(), want) <= 1e-4
    jcache = jm.init_cache(B, max_len, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_len, dtype=torch.float32)
    feed = [prompt] + list(tokens(tm.cfg.vocab, (2, B, 1), seed=14))
    at = 0
    for toks in feed:
        want, jcache = _ref_decode(jm, params, jcache, toks, at)
        got, tcache = tm.apply({"tokens": torch.from_numpy(toks)}, cache=tcache,
                               cache_index=at)
        assert rel(got.numpy(), want) <= 1e-4
        at += toks.shape[1]


def test_cache_view_is_shared_and_equals_a_layer_own(monkeypatch):
    """``Model.apply`` forms the cache rows' positions, valid prefixes and
    masks once a call (one mask per layer window: gemma2's local and
    global); a layer given no view forms the same one itself."""
    _, _, tm = models("gemma2-9b")
    B, S, S_max, at = 2, 3, 20, 5
    pos = torch.arange(at, at + S)[None].expand(B, S)
    windows = [b.meta.window for b in tm.layers]
    view = tattn.cache_view(tm.cfg, pos, S_max, at, windows)
    assert sorted(view.masks, key=str) == sorted(set(windows), key=str)
    assert view.kv_len.tolist() == [at + S] * B and view.kv_pos.shape == (1, S_max)
    for w in set(windows):
        own = tattn.cache_view(tm.cfg, pos, S_max, at, (w,)).masks[w]
        assert torch.equal(view.masks[w], own)
        assert torch.equal(own, tattn._mask(pos, view.kv_pos, True, w, view.kv_len))
    assert tattn.cache_view(tm.cfg, pos, S_max, at, windows, "blockwise").masks is None
    seen = []
    real = tattn.cache_view
    monkeypatch.setattr(tattn, "cache_view", lambda *a: seen.append(a) or real(*a))
    tm.apply({"tokens": torch.zeros((B, S), dtype=torch.int64)},
             cache=tm.init_cache(B, S_max, dtype=torch.float32), cache_index=at)
    assert len(seen) == 1


def test_cache_from_numpy_layout():
    """One entry per layer in layer order, the period axis unstacked
    (gemma2's period of 2), dtypes kept (bfloat16 too)."""
    jm, params, tm = models("gemma2-9b")
    jcache = jm.init_cache(2, 8)                      # the reference's bfloat16 default
    tree = numpy_tree(jcache)
    tree["body"][1][0][0, 1, 3] = 1.5                 # layer 1: period position 1
    got = convert.cache_from_numpy(tm.cfg, tree, device="cpu")
    own = tm.init_cache(2, 8)
    assert len(got) == len(own) == tm.cfg.n_layers
    for g, o in zip(got, own):
        assert [x.shape for x in g] == [x.shape for x in o]
        assert [x.dtype for x in g] == [x.dtype for x in o] == [torch.bfloat16] * 2
    assert float(got[1][0][1, 3].max()) == 1.5 and float(got[0][0].abs().max()) == 0.0
