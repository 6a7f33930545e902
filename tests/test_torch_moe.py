"""PyTorch port vs JAX reference: the MoE FFN (``models/moe.py``), the MoE
blocks and the summed aux loss, on the CPU at reduced mixtral-8x22b (2
layers, d 256, 4 experts, top 2, f 256).

Weights are the reference's ``PRNGKey(0)`` draws carried across by
``convert``; inputs are made with numpy from a seed.  Tolerances: the
router's gate weights and probabilities 1e-6 (absolute, both in [0, 1]),
the aux loss 1e-6 relative; an MoE layer's output 1e-5 relative to the
reference's largest |value| (the experts' products in another order), the
kept choices equal; whole-model logits 1e-4 (two layers of float32
products in another order).  The expert ids are equal, ties included:
``jax.lax.top_k`` puts the lower index first, and so does the port.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from _torch_moe_cases import first_choices, per_expert_route  # noqa: E402
from _torch_serve_cases import (calls_agree, models, numpy_tree, rel, serve_both,  # noqa: E402
                                t, tokens)

NAME = "mixtral-8x22b"
TIE = 1e-4


def _cfgs(**moe_kw):
    """(reference cfg, port cfg), reduced mixtral with ``moe_kw`` replaced."""
    out = []
    for cfg in (jcfg.get(NAME, reduced=True), tcfg.get(NAME, reduced=True)):
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return tuple(out)


def _layer_params(seed=0):
    """One reduced MoE layer's params from the reference's initialiser: the
    reference's ``MoEParams`` and the port's dict of tensors."""
    jp = jmoe.init(jax.random.PRNGKey(seed), jcfg.get(NAME, reduced=True))
    return jp, {k: t(v) for k, v in numpy_tree(jp).items()}


def _x(case, d, seed=1):
    """(B, S, d) float32 layer input: 'random' normal rows, or 'identical':
    the reference test's 2 x 32 copies of one row (every token the same
    pair of experts)."""
    rng = np.random.default_rng(seed)
    if case == "identical":
        return np.broadcast_to(rng.standard_normal((1, 1, d)), (2, 32, d)).astype(np.float32)
    return rng.standard_normal((2, 24, d)).astype(np.float32)


@pytest.mark.parametrize("tied", [False, True])
def test_route_matches_reference(tied):
    jp, tp = _layer_params()
    router = np.array(jp.router)
    if tied:
        router[:, 2] = router[:, 1]              # two equal columns: tied probabilities
    x = np.random.default_rng(3).standard_normal((96, router.shape[0])).astype(np.float32)
    k = jcfg.get(NAME, reduced=True).moe.top_k
    jgw, jids, jaux, jprobs = (np.asarray(v) for v in jmoe.route(jnp.asarray(router),
                                                                 jnp.asarray(x), k))
    gw, ids, aux, probs = tmoe.route(t(router), t(x), k)
    if tied:
        assert np.array_equal(jprobs[:, 1], jprobs[:, 2])
        assert np.array_equal(probs[:, 1].numpy(), probs[:, 2].numpy())
        # the tie decides some choices: both columns chosen, or one at the cut
        assert np.isin(jids, [1, 2]).any(-1).sum() > 10
    assert np.array_equal(ids.numpy(), jids)
    assert np.max(np.abs(gw.numpy() - jgw)) <= 1e-6
    assert np.max(np.abs(probs.numpy() - jprobs)) <= 1e-6
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_top_k_breaks_ties_on_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.0, 0.5, 0.0, 0.5], [0.3, 0.2, 0.3, 0.2]])
    _, ids = tmoe._top_k(probs, 3)
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1])
    assert np.array_equal(ids.numpy(), want)
    assert ids.tolist() == [[0, 1, 2], [1, 3, 0], [1, 3, 0], [0, 2, 1]]


@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
def test_capacity_matches_reference(factor):
    for name in (NAME, "deepseek-v3-671b"):
        for reduced in (True, False):
            jc = jcfg.get(name, reduced=reduced)
            tc = tcfg.get(name, reduced=reduced)
            jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                                 capacity_factor=factor))
            tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                                 capacity_factor=factor))
            for T in (1, 4, 63, 64, 1000, 8192):
                C = tmoe.capacity(T, tc)
                assert C == jmoe.capacity(T, jc), (name, reduced, T)
                assert C % 8 == 0 and C >= 8


@pytest.mark.parametrize("case,factor,drops", [
    ("random", 8.0, False),           # ample capacity: nothing dropped
    ("identical", 1.25, True),        # the config's factor: C = 40 of 64 choices
    ("identical", 1.0, True),         # C = 32
])
def test_moe_apply_matches_reference(case, factor, drops):
    jc, tc = _cfgs(capacity_factor=factor)
    jp, tp = _layer_params()
    x = _x(case, tc.d_model)
    want, jaux = jmoe.apply(jp, jc, jnp.asarray(x))
    got, aux = tmoe.apply(tp, tc, t(x))
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    assert rel(got.numpy(), want) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))

    # the kept choices: the port's dispatch rule, the reference's (its
    # cumsum over the flattened choices, in numpy from its own ids) and
    # each expert's first C choices by a loop
    E, k = tc.moe.n_experts, tc.moe.top_k
    T = x.shape[0] * x.shape[1]
    C = tmoe.capacity(T, tc)
    jids = np.asarray(jmoe.route(jp.router, jnp.asarray(x.reshape(T, -1)), k)[1]).reshape(-1)
    pos = (np.cumsum(np.eye(E, dtype=np.int64)[jids], axis=0) - 1)[np.arange(T * k), jids]
    ids = tmoe.route(tp["router"], t(x.reshape(T, -1)), k)[1].reshape(-1)
    _, keep = tmoe.slots(ids, E, C)
    assert np.array_equal(keep.numpy(), pos < C)
    assert torch.equal(keep, first_choices(ids, E, C))
    assert bool((~keep).any()) == drops
    if case == "identical":
        # both experts of the pair get every token; each keeps its first C
        assert sorted(torch.bincount(ids, minlength=E).tolist())[-2:] == [T, T]
        assert int(keep.sum()) == 2 * C

    # the independent route, in float32 and in float64
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-5)):
        out, raux, kept = per_expert_route(tp, tc, t(x), dtype)
        assert torch.equal(kept, keep)
        assert rel(got.numpy(), out.numpy()) <= tol
        assert abs(float(aux) - raux) <= 1e-6 * raux


def test_model_forward_and_aux_match_reference():
    """Reduced mixtral's cache-less forward over 2 x 80 tokens (past its
    reduced window of 64), at the config's capacity factor: logits and the
    summed aux loss of its two MoE layers."""
    jm, params, tm = models(NAME)
    toks = tokens(tm.cfg.vocab, (2, 80), seed=5)
    want, _, jaux = jm.apply(params, {"tokens": jnp.asarray(toks, dtype=jnp.int32)})
    got, aux = tm.apply({"tokens": torch.from_numpy(toks)}, return_aux=True)
    assert rel(got.numpy(), want) <= 1e-4
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert torch.equal(tm.apply({"tokens": torch.from_numpy(toks)}), got)
    # a model without MoE layers: the reference's zero
    _, _, dense = models("tinyllama-1.1b")
    _, zero = dense.apply({"tokens": torch.from_numpy(toks % dense.cfg.vocab)},
                          return_aux=True)
    assert float(zero) == 0.0


def test_decode_matches_teacher_forcing():
    """The reference's ``test_decode_matches_teacher_forcing`` for mixtral,
    at its ample capacity (factor 8.0): the port's cached prefill within
    2e-4 of its own forward and its decode within 2e-3 (the reference's
    bounds), and each of the three within 1e-4 of the reference's."""
    jc, tc = _cfgs(capacity_factor=8.0)
    _, params, tm0 = models(NAME)
    jm = JModel(jc)
    tm = ttr.Model(tc, device="cpu")
    tm.load_state_dict(tm0.state_dict())
    B, S = 2, 16
    toks = tokens(tc.vocab, (B, S), seed=6)
    jt = jnp.asarray(toks, dtype=jnp.int32)
    jfull, _, _ = jm.apply(params, {"tokens": jt})
    full = tm.apply({"tokens": torch.from_numpy(toks)})
    cache = tm.init_cache(B, S + 4, dtype=torch.float32)
    pre, cache, aux = tm.apply({"tokens": torch.from_numpy(toks)}, cache=cache,
                               cache_index=0, return_aux=True)
    assert float(np.max(np.abs(pre.numpy() - full.numpy()))) <= 2e-4
    nxt = full[:, -1:].argmax(-1)
    dec, cache = tm.apply({"tokens": nxt}, cache=cache, cache_index=S)
    ref = tm.apply({"tokens": torch.cat([torch.from_numpy(toks), nxt], 1)})
    assert float(np.max(np.abs(dec[:, -1].numpy() - ref[:, -1].numpy()))) <= 2e-3

    jcache = jm.init_cache(B, S + 4, dtype=jnp.float32)
    jpre, jcache, jaux = jm.apply(params, {"tokens": jt}, cache=jcache,
                                  cache_index=jnp.int32(0))
    jnxt = jnp.asarray(nxt.numpy(), dtype=jnp.int32)
    jdec, _, _ = jm.apply(params, {"tokens": jnxt}, cache=jcache, cache_index=jnp.int32(S))
    assert rel(full.numpy(), jfull) <= 1e-4
    assert rel(pre.numpy(), jpre) <= 1e-4
    assert rel(dec.numpy(), jdec) <= 1e-4
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_four_slot_engine_tokens_match_reference():
    """Six requests through four slots (two refills), at the config's
    capacity factor: every decode call's tokens and logits the reference's.
    A decode step routes at most four tokens into C = 8 rows an expert, so
    neither engine drops a choice."""
    jm, params, tm = models(NAME)
    assert tmoe.capacity(4, tm.cfg) == 8
    prompts = [tokens(tm.cfg.vocab, 12, seed=40 + i) for i in range(6)]
    rcalls, pcalls, want, got = serve_both(jm, params, tm, prompts, slots=4, max_new=8)
    assert len(pcalls) == len(rcalls) > 6 * 12
    if not calls_agree(rcalls, pcalls, TIE):
        return                                        # parted at a tie
    assert sorted(got) == sorted(want) == list(range(1, 7))
    assert all(got[u] == want[u] and len(got[u]) == 8 for u in want)


def test_convert_carries_expert_tensors():
    """``model_params_from_numpy`` unstacks mixtral's (n_periods, E, d, f)
    expert tensors into one entry per layer (period 1: layer i is period
    i), and keeps the shared experts zero-width; the port's state reads
    back the reference's arrays."""
    _, params, tm = models(NAME)
    tree = numpy_tree(params)
    ffn = tree["body"][0]["ffn"]
    cfg = tm.cfg
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    assert ffn["w_gate"].shape == (cfg.n_layers, E, d, f)
    assert ffn["w_down"].shape == (cfg.n_layers, E, f, d)
    sd = convert.model_params_from_numpy(cfg, tree)
    assert set(sd) == set(tm.state_dict())
    own = tm.state_dict()
    for i in range(cfg.n_layers):
        for name in ("router", "w_gate", "w_up", "w_down"):
            key = f"layers.{i}.ffn.{name}"
            assert np.array_equal(own[key].numpy(), ffn[name][i])
        assert own[f"layers.{i}.ffn.shared_gate"].shape == (d, 0)
        assert own[f"layers.{i}.ffn.shared_down"].shape == (0, d)
    assert not np.array_equal(ffn["w_up"][0], ffn["w_up"][1])
