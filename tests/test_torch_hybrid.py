"""PyTorch port vs JAX reference: the Jamba hybrid (jamba-v0.1-52b), on the
CPU.

Two configurations, both narrow (d 256, 4 heads, 4 experts of f 256, top
2, MoE every second layer):

* ``reduced``: the reference's reduced Jamba, 2 layers at period 2,
  offset 1 (SSM + MoE, attention + dense FFN), ``d_state`` 32, head_dim 32;
* ``two-period``: 16 layers at the full config's period 8 and offset 3
  (attention on layers 3 and 11), ``d_state`` 16 and head_dim 64 (the full
  config's SSM shape, the ``ssd_chunk`` kernel's (64, 16) pair), built with
  ``dataclasses.replace`` on the reduced config.  It carries the
  reference's period-8 stacks through ``convert`` and runs the N = 16
  plain SSD path.

Weights are the reference's ``PRNGKey(0)`` draws carried across by
``convert``; inputs are made with numpy from a seed.  Tolerances, as
``test_torch_moe.py``: logits 1e-4 relative to the reference's largest
|value| (layers of float32 products in another order), the summed aux loss
1e-6 relative; the reference's decode test's own bounds (prefill 2e-4,
decode 2e-3 absolute) for the port against itself; the engine's tokens
equal.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from _torch_moe_cases import recorded_routes  # noqa: E402
from _torch_serve_cases import calls_agree, numpy_tree, rel, serve_both, tokens  # noqa: E402

NAME = "jamba-v0.1-52b"
TIE = 1e-4
VARIANTS = ["reduced", "two-period"]


def _cfg(pkg, variant, **moe_kw):
    """``pkg``'s (``jcfg`` or ``tcfg``) config of ``variant``, with the MoE
    fields ``moe_kw`` replaced."""
    cfg = pkg.get(NAME, reduced=True)
    if variant == "two-period":
        cfg = dataclasses.replace(
            cfg, n_layers=16, hybrid_attn_period=8, hybrid_attn_offset=3,
            ssm=dataclasses.replace(cfg.ssm, d_state=16, head_dim=64))
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    cfg.validate()
    return cfg


@functools.lru_cache(maxsize=None)
def _models(variant, **moe_kw):
    """(reference model, its params, the port's CPU model with those
    weights) of ``variant``; the weights do not depend on ``moe_kw``."""
    jm = JModel(_cfg(jcfg, variant, **moe_kw))
    params = _params(variant)
    tm = ttr.Model(_cfg(tcfg, variant, **moe_kw), device="cpu")
    tm.load_state_dict(convert.model_params_from_numpy(tm.cfg, numpy_tree(params)))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def _params(variant):
    return JModel(_cfg(jcfg, variant)).init(jax.random.PRNGKey(0))


def test_hybrid_is_supported():
    """The full config passes ``check_supported`` and the reduced one builds
    (MLA and the frontends still raise: ``test_torch_models.py``'s
    ``test_unported_features_raise``)."""
    tblocks.check_supported(tcfg.get(NAME))
    m = ttr.make_model(NAME, reduced=True, device="cpu")
    assert [(b.meta.kind, b.meta.is_moe, b.has_ffn) for b in m.layers] == [
        ("ssm", True, True), ("attn", False, True)]


def test_layer_kinds_follow_the_reference():
    """The full config's interleave: attention on layer 3 of each period of
    8, MoE on the even layers, an FFN on every layer; the port's config
    methods give the reference's for all 32 layers."""
    full, jfull = tcfg.get(NAME), jcfg.get(NAME)
    kinds = [(full.layer_kind(i), full.layer_is_moe(i)) for i in range(full.n_layers)]
    assert kinds == [(jfull.layer_kind(i), jfull.layer_is_moe(i))
                     for i in range(full.n_layers)]
    assert [i for i, (k, _) in enumerate(kinds) if k == "attn"] == [3, 11, 19, 27]
    assert [i for i, (_, moe) in enumerate(kinds) if moe] == list(range(0, 32, 2))
    assert convert._layer_period(full) == (0, 8)
    two = _cfg(tcfg, "two-period")
    assert [two.layer_kind(i) for i in range(16)] == (["ssm"] * 3 + ["attn"] + ["ssm"] * 7
                                                      + ["attn"] + ["ssm"] * 4)
    assert convert._layer_period(two) == (0, 8)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_and_aux_match_reference(variant):
    """The cache-less forward over 2 x 256 tokens (two SSD chunks) at the
    config's capacity factor: logits within 1e-4 of the reference's (its
    jnp path and its Pallas kernels in interpret mode), the aux loss summed
    over the MoE layers within 1e-6."""
    jm, params, tm = _models(variant)
    toks = tokens(tm.cfg.vocab, (2, 256), seed=5)
    jt = {"tokens": jnp.asarray(toks, dtype=jnp.int32)}
    want, _, jaux = jm.apply(params, jt)
    with recorded_routes() as routes:
        got, aux = tm.apply({"tokens": torch.from_numpy(toks)}, return_aux=True)
    assert len(routes) == sum(b.meta.is_moe for b in tm.layers) == tm.cfg.n_layers // 2
    assert got.shape == (2, 256, tm.cfg.vocab) and bool(torch.isfinite(got).all())
    assert rel(got.numpy(), want) <= 1e-4
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    kernel, _, _ = JModel(jm.cfg, use_kernel=True).apply(params, jt)
    assert rel(got.numpy(), kernel) <= 1e-4


def test_convert_unstacks_period_eight():
    """``model_params_from_numpy`` unstacks the two-period variant's
    period-8 stacks: layer ``8 c + p`` is ``body[p][...][c]``, with the
    four block kinds at their positions (SSM + MoE at 0, 2, 4, 6; SSM +
    dense at 1, 5, 7; attention + dense at 3)."""
    _, params, tm = _models("two-period")
    tree = numpy_tree(params)
    assert len(tree["body"]) == 8 and not tree["prefix"]
    sd = convert.model_params_from_numpy(tm.cfg, tree)
    assert set(sd) == set(tm.state_dict())
    own = tm.state_dict()
    for p, block in enumerate(tree["body"]):
        mixer, ffn = block["mixer"], block["ffn"]
        assert ("wq" in mixer) == (p == 3) and ("w_in" in mixer) == (p != 3)
        assert ("router" in ffn) == (p % 2 == 0)
        for c in range(2):
            i = 8 * c + p
            for part in ("mixer", "ffn"):
                for name, arr in block[part].items():
                    assert np.array_equal(own[f"layers.{i}.{part}.{name}"].numpy(), arr[c])
            assert np.array_equal(own[f"layers.{i}.ln1"].numpy(), block["ln1"][c])
    assert own["layers.0.ffn.w_gate"].shape == (4, 256, 256)       # experts
    assert own["layers.1.ffn.w_gate"].shape == (256, 512)          # dense
    assert own["layers.3.mixer.wq"].shape[0] == 256
    assert own["layers.0.mixer.a_log"].shape == (8,)               # d_inner 512 / 64
    assert not np.array_equal(own["layers.0.mixer.w_in"].numpy(),
                              own["layers.8.mixer.w_in"].numpy())


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_cache_kinds_and_shapes(variant):
    """``Model.init_cache``: (k, v) on the attention layers, (conv state,
    float32 SSM state) on the SSM layers, each the shape and dtype of the
    reference's cache entry for that layer (unstacked by ``convert``)."""
    jm, _, tm = _models(variant)
    B, L = 3, 40
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tm.init_cache(B, L, dtype=dtype)
        want = convert.cache_from_numpy(tm.cfg, numpy_tree(jm.init_cache(B, L, dtype=jdtype)),
                                        device="cpu")
        assert len(got) == len(want) == tm.cfg.n_layers
        for block, g, w in zip(tm.layers, got, want):
            assert [(tuple(x.shape), x.dtype) for x in g] == [(tuple(x.shape), x.dtype)
                                                              for x in w], block.meta
            assert all(not bool(x.any()) for x in g)
            if block.meta.kind == "attn":
                assert g[0].shape == (B, L, tm.cfg.n_kv_heads, tm.cfg.hd)
                assert g[0].dtype == dtype
            else:
                s = tm.cfg.ssm
                nh = s.n_heads(tm.cfg.d_model)
                assert g[1].shape == (B, nh, s.head_dim, s.d_state)
                assert g[1].dtype == torch.float32 and g[0].dtype == dtype


def test_full_config_cache_kinds():
    """The full config's per-layer cache entries, from ``init_block_cache``
    without building the model: (k, v) of 8 KV heads of 128 on layers 3,
    11, 19, 27; elsewhere the conv state over d_inner + 2 d_state = 8,224
    channels and the (128, 64, 16) float32 SSM state."""
    cfg = tcfg.get(NAME)
    shapes = [[tuple(x.shape) for x in tblocks.init_block_cache(
        cfg, tblocks.layer_meta(cfg, i), 2, 24, torch.float32, "cpu")]
        for i in range(cfg.n_layers)]
    for i, s in enumerate(shapes):
        if i % 8 == 3:
            assert s == [(2, 24, 8, 128)] * 2
        else:
            assert s == [(2, 3, 8224), (2, 128, 64, 16)]


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_matches_teacher_forcing(variant):
    """The reference's ``test_decode_matches_teacher_forcing`` for Jamba, at
    its ample capacity (factor 8.0): the port's cached prefill within 2e-4
    of its own forward and its decode within 2e-3 (the reference's
    bounds), and each of the three within 1e-4 of the reference's; the
    summed aux loss of the cached prefill the reference's.  The attention
    layer's cache is written in place, the SSM layers' entries are new."""
    jm, params, tm = _models(variant, capacity_factor=8.0)
    B, S = 2, 16
    toks = tokens(tm.cfg.vocab, (B, S), seed=6)
    jt = jnp.asarray(toks, dtype=jnp.int32)
    jfull, _, _ = jm.apply(params, {"tokens": jt})
    full = tm.apply({"tokens": torch.from_numpy(toks)})
    cache = tm.init_cache(B, S + 4, dtype=torch.float32)
    empty = list(cache)
    pre, cache, aux = tm.apply({"tokens": torch.from_numpy(toks)}, cache=cache,
                               cache_index=0, return_aux=True)
    for block, old, new in zip(tm.layers, empty, cache):
        same = [a is b for a, b in zip(old, new)]
        assert same == ([True, True] if block.meta.kind == "attn" else [False, False])
    assert float(np.max(np.abs(pre.numpy() - full.numpy()))) <= 2e-4
    nxt = full[:, -1:].argmax(-1)
    dec, cache = tm.apply({"tokens": nxt}, cache=cache, cache_index=S)
    ref = tm.apply({"tokens": torch.cat([torch.from_numpy(toks), nxt], 1)})
    assert float(np.max(np.abs(dec[:, -1].numpy() - ref[:, -1].numpy()))) <= 2e-3

    jcache = jm.init_cache(B, S + 4, dtype=jnp.float32)
    jpre, jcache, jaux = jm.apply(params, {"tokens": jt}, cache=jcache,
                                  cache_index=jnp.int32(0))
    jnxt = jnp.asarray(nxt.numpy(), dtype=jnp.int32)
    jdec, jcache, _ = jm.apply(params, {"tokens": jnxt}, cache=jcache,
                               cache_index=jnp.int32(S))
    assert rel(full.numpy(), jfull) <= 1e-4
    assert rel(pre.numpy(), jpre) <= 1e-4
    assert rel(dec.numpy(), jdec) <= 1e-4
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # the caches after the decode step, entry by entry
    for got, want in zip(cache, convert.cache_from_numpy(tm.cfg, numpy_tree(jcache),
                                                         device="cpu")):
        for g, w in zip(got, want):
            assert rel(g.numpy(), w.numpy()) <= 1e-4


def test_drops_at_capacity_factor_one():
    """At capacity factor 1.0 (C = 128 rows an expert for 2 x 128 tokens,
    top 2 of 4) the reduced model's MoE layer drops choices, the same ones
    as the reference's dispatch rule; logits and aux loss within the
    forward's bounds of the reference's."""
    jm, params, tm = _models("reduced", capacity_factor=1.0)
    toks = tokens(tm.cfg.vocab, (2, 128), seed=9)
    want, _, jaux = jm.apply(params, {"tokens": jnp.asarray(toks, dtype=jnp.int32)})
    with recorded_routes() as routes:
        got, aux = tm.apply({"tokens": torch.from_numpy(toks)}, return_aux=True)
    T, E, k = 256, tm.cfg.moe.n_experts, tm.cfg.moe.top_k
    C = tmoe.capacity(T, tm.cfg)
    ids = routes[0].reshape(-1)
    _, keep = tmoe.slots(ids, E, C)
    assert C == 128 and int((~keep).sum()) > 0
    assert max(torch.bincount(ids, minlength=E).tolist()) > C
    pos = (np.cumsum(np.eye(E, dtype=np.int64)[ids.numpy()], axis=0) - 1)[np.arange(T * k),
                                                                          ids.numpy()]
    assert np.array_equal(keep.numpy(), pos < C)
    assert rel(got.numpy(), want) <= 1e-4
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # the config's own factor drops fewer
    _, _, tm125 = _models("reduced")
    assert tmoe.capacity(T, tm125.cfg) > C


def test_four_slot_engine_tokens_match_reference():
    """Six requests through four slots (two refills) over the hybrid cache
    (the attention layer's rows written in place, the SSM states new each
    step, the reference's cross-slot quirks kept): every decode call's
    tokens and logits the reference's.  A decode step routes at most four
    tokens into C = 8 rows an expert, so neither engine drops a choice."""
    jm, params, tm = _models("reduced")
    assert tmoe.capacity(4, tm.cfg) == 8
    prompts = [tokens(tm.cfg.vocab, 12, seed=50 + i) for i in range(6)]
    rcalls, pcalls, want, got = serve_both(jm, params, tm, prompts, slots=4, max_new=8)
    assert len(pcalls) == len(rcalls) > 6 * 12
    if not calls_agree(rcalls, pcalls, TIE):
        return                                        # parted at a tie
    assert sorted(got) == sorted(want) == list(range(1, 7))
    assert all(got[u] == want[u] and len(got[u]) == 8 for u in want)
