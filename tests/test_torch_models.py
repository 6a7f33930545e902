"""PyTorch port vs JAX reference: the model substrate of the edge-serving
chains, on the CPU.

The port's kernels run their plain versions here (CPU tensors); the
reference runs its Pallas kernels in interpret mode (``ops.*``) and its
pure-jnp oracles (``kernels.ref``).  Inputs are made with numpy from a
seed and handed to both.  Weights cross as numpy arrays through
``convert.model_params_from_numpy``.  Tolerances, relative to the largest
|value| of the reference output: the kernels' plain versions 2e-5 (another
summation order), the norm/RoPE/SwiGLU layers 1e-6, the chunked SSD 1e-5,
whole-model logits 1e-4 (two layers of float32 matmuls in another order).
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_chunk as tsc  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

ARCHS = ["internlm2-1.8b", "mamba2-780m"]


def _rel(got, want):
    """Largest |got - want| relative to the largest |want|."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _heads_first(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1, 3))


# ---------------------------------------------------------------------------
# flash attention: plain version vs the Pallas kernel and the jnp oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,KV,causal,window", [
    (256, 4, 4, True, None),       # causal
    (256, 4, 4, True, 64),         # sliding window
    (256, 4, 2, True, None),       # GQA rep=2
    (256, 8, 2, True, 96),         # GQA rep=4, window not a tile multiple
    (130, 4, 2, True, None),       # padding path (S % 128 != 0)
])
def test_flash_plain_matches_reference(S, H, KV, causal, window):
    q, k, v = _qkv(S + H + KV, 2, S, H, KV, 64)
    kw = dict(causal=causal, window=window)
    got = tops.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), **kw))
    oracle = np.asarray(jref.flash_attention(*(jnp.asarray(_heads_first(x))
                                               for x in (q, k, v)), **kw))
    assert _rel(got, pallas) <= 2e-5
    assert _rel(got, oracle.transpose(0, 2, 1, 3)) <= 2e-5
    # the plain version itself, in the kernel's (B, H, S, hd) layout
    direct = tfa.flash_attention_plain(*(_t(_heads_first(x)) for x in (q, k, v)), **kw)
    assert _rel(direct.numpy(), oracle) <= 2e-5


def test_flash_noncausal_padding_caveat():
    """Non-causal with S % 128 != 0: the port masks the padded keys (it
    passes the true length), so it matches ``attention.sdpa``; the
    reference's wrapper passes the padded length and attends to the zero
    keys in the padding (ROADMAP Queue 3, reference caveat)."""
    S, H, KV, hd = 100, 4, 2, 64
    q, k, v = _qkv(7, 1, S, H, KV, hd)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (1, S))
    want = np.asarray(jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_pos=pos, kv_pos=pos, causal=False))
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=False).numpy()
    assert _rel(got, want) <= 2e-5
    tpos = torch.arange(S)[None]
    port_sdpa = tattn.sdpa(_t(q), _t(k), _t(v), q_pos=tpos, kv_pos=tpos, causal=False)
    assert _rel(port_sdpa.numpy(), want) <= 2e-5
    gap = np.max(np.abs(np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)) - want))
    assert 0.05 < gap < 0.5           # the reference wrapper's caveat: 0.116


# ---------------------------------------------------------------------------
# SSD chunk: plain version vs the Pallas kernel and the jnp oracle
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, nc, Q, H, P, N, G):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xh = rng.standard_normal((1, nc, Q, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((1, nc, Q, H)))).astype(f32)
    A = -np.exp(0.2 * rng.standard_normal(H)).astype(f32)
    cum = np.cumsum(dt * A, axis=2, dtype=f32)
    Bc = (0.3 * rng.standard_normal((1, nc, Q, G, N))).astype(f32)
    Cc = (0.3 * rng.standard_normal((1, nc, Q, G, N))).astype(f32)
    return xh, dt, cum, Bc, Cc


@pytest.mark.parametrize("Q,H,P,N,G", [(128, 2, 32, 16, 2), (128, 4, 64, 128, 1),
                                        (64, 4, 32, 32, 2)])
def test_ssd_plain_matches_reference(Q, H, P, N, G):
    xh, dt, cum, Bc, Cc = _ssd_inputs(Q + H + N, 2, Q, H, P, N, G)
    BH = np.repeat(Bc, H // G, axis=3)
    CH = np.repeat(Cc, H // G, axis=3)
    y, st = tops.ssd_chunk(*(_t(x) for x in (xh, dt, cum, Bc, Cc)))
    ja = [jnp.asarray(x) for x in (xh, dt, cum, BH, CH)]
    yp, sp = jops.ssd_chunk(ja[0], ja[1], None, ja[2], ja[3], ja[4])
    yo, so = jref.ssd_chunk(*ja)
    for got, want in ((y, yp), (st, sp), (y, yo), (st, so)):
        assert _rel(got.numpy(), want) <= 2e-5
    # read by group or repeated per head: one function
    y2, st2 = tsc.ssd_chunk_plain(*(_t(x) for x in (xh, dt, cum, BH, CH)))
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_ssd_chunked_two_chunks_matches_reference():
    B, S, H, P, G, N = 2, 256, 4, 32, 1, 32
    rng = np.random.default_rng(3)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.2 * rng.standard_normal(H)).astype(np.float32)
    Bc = (0.3 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    Cc = (0.3 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    y, h = tssm.ssd_chunked(*(_t(x) for x in (xh, dt, A, Bc, Cc)))
    for use_kernel in (False, True):
        yr, hr = jssm.ssd_chunked(*(jnp.asarray(x) for x in (xh, dt, A, Bc, Cc)),
                                  use_kernel=use_kernel)
        assert _rel(y.numpy(), yr) <= 1e-5
        assert _rel(h.numpy(), hr) <= 1e-5


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_rope_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    assert _rel(tlayers.rms_norm(_t(x), _t(scale), 1e-5).numpy(),
                jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)) <= 1e-6
    pos = np.broadcast_to(np.arange(16)[None], (2, 16)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        got = tlayers.apply_rope(_t(x), torch.from_numpy(pos.astype(np.int64)), theta)
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        assert _rel(got.numpy(), want) <= 1e-6
    h = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ws = [(rng.standard_normal(s) / 8).astype(np.float32)
          for s in ((64, 128), (64, 128), (128, 64))]
    for act in ("silu", "gelu", "relu"):
        got = tlayers.swiglu(_t(h), *(_t(w) for w in ws), act=act)
        want = jlayers.swiglu(jnp.asarray(h), *(jnp.asarray(w) for w in ws), act=act)
        assert _rel(got.numpy(), want) <= 1e-6


# ---------------------------------------------------------------------------
# whole models on the reduced configs
# ---------------------------------------------------------------------------

def _numpy_tree(x):
    """The reference's params pytree as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: _numpy_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_numpy_tree(v) for v in x]
    return np.asarray(x)


_MODELS = {}


def _models(name):
    """(reference model, its params, the port's model with those weights)."""
    if name not in _MODELS:
        cfg = jcfg.get(name, reduced=True)
        jm = JModel(cfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = ttr.make_model(name, reduced=True, device="cpu")
        tm.load_state_dict(convert.model_params_from_numpy(tm.cfg, _numpy_tree(params)))
        _MODELS[name] = (jm, params, tm)
    return _MODELS[name]


def _tokens(cfg, B=2, S=256, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", ARCHS)
def test_model_logits_match_reference(name, use_kernel):
    jm, params, tm = _models(name)
    toks = _tokens(tm.cfg)
    ref = JModel(jm.cfg, use_kernel=use_kernel)
    want, _, _ = ref.apply(params, {"tokens": jnp.asarray(toks, dtype=jnp.int32)})
    got = tm.apply({"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 256, tm.cfg.vocab)
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("S", [32, 100])
def test_short_ssm_prefill_matches_reference(S):
    """A mamba2 prefill shorter than one 128-token chunk (S = 32 is the edge
    example's packet): ``ops.ssd_chunk`` pads the chunk to the kernel's 128
    rows, and the logits still match the reference's (which runs Q = S)."""
    jm, params, tm = _models("mamba2-780m")
    toks = _tokens(tm.cfg, S=S, seed=S)
    for use_kernel in (True, False):
        want, _, _ = JModel(jm.cfg, use_kernel=use_kernel).apply(
            params, {"tokens": jnp.asarray(toks, dtype=jnp.int32)})
        got = tm.apply({"tokens": torch.from_numpy(toks)})
        assert got.shape == (2, S, tm.cfg.vocab)
        assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("name", ARCHS)
def test_split_forward_equals_monolithic(name):
    from repro_torch.core import chain

    _, _, tm = _models(name)
    batch = {"tokens": torch.from_numpy(_tokens(tm.cfg, seed=2))}
    mono = tm.apply(batch)
    lo, mid, hi = (int(b) for b in chain.segment_bounds(tm.cfg.n_layers, 2))
    x = tm.apply_layers(tm.embed(batch), lo, mid)
    packet = x.clone()                      # the activation shipped between nodes
    split = tm.head(tm.apply_layers(packet, mid, hi))
    assert torch.equal(split, mono)


@pytest.mark.parametrize("name", ARCHS)
def test_converted_state_matches_model(name):
    """The converted state fills every parameter of the port's model exactly
    once, with the reference's shapes, and the port's config equals the
    reference's field by field."""
    jm, params, tm = _models(name)
    sd = convert.model_params_from_numpy(tm.cfg, _numpy_tree(params))
    own = tm.state_dict()
    assert sorted(sd) == sorted(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)


def test_model_init_distributions():
    """``Model.init`` draws the reference's distributions: embeddings N(0, 1),
    projections N(0, 1/fan_in), norms 0, the SSM's A = -(1..nh), D = 1."""
    tm = ttr.make_model("mamba2-780m", reduced=True, device="cpu").init(5)
    assert abs(float(tm.embedding.std()) - 1.0) < 0.02
    w_in = tm.layers[0].mixer["w_in"]
    assert abs(float(w_in.std()) * w_in.shape[0] ** 0.5 - 1.0) < 0.02
    assert float(tm.final_norm.abs().max()) == 0.0
    nh = tm.layers[0].mixer["a_log"].numel()
    assert torch.allclose(torch.exp(tm.layers[0].mixer["a_log"]),
                          torch.arange(1, nh + 1, dtype=torch.float32))
    assert float(tm.layers[0].mixer["d_skip"].min()) == 1.0
    again = ttr.make_model("mamba2-780m", reduced=True, device="cpu").init(5)
    assert torch.equal(again.layers[1].mixer["w_out"], tm.layers[1].mixer["w_out"])


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "mixtral-8x22b", "jamba-v0.1-52b",
                                  "gemma2-9b", "hubert-xlarge", "llava-next-34b"])
def test_unported_features_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, Transformer substrate, the rest"):
        ttr.make_model(name, reduced=True, device="cpu")


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "phi4-mini-3.8b"])
def test_other_dense_gqa_archs_match_reference(name):
    cfg = jcfg.get(name, reduced=True)
    params = JModel(cfg).init(jax.random.PRNGKey(1))
    tm = ttr.make_model(name, reduced=True, device="cpu")
    tm.load_state_dict(convert.model_params_from_numpy(tm.cfg, _numpy_tree(params)))
    toks = _tokens(cfg, B=1, S=128, seed=3)
    want, _, _ = JModel(cfg).apply(params, {"tokens": jnp.asarray(toks, dtype=jnp.int32)})
    assert _rel(tm.apply({"tokens": torch.from_numpy(toks)}).numpy(), want) <= 1e-4
