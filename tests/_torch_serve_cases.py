"""Shared inputs of the serving-path parity tests (``test_torch_decode.py``,
``test_torch_serve.py``): the reference's reduced model and the port's
model with the same weights, and the comparison they use."""

import functools

import jax
import numpy as np
import torch

from repro import configs as jcfg
from repro.models.transformer import Model as JModel
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine


def rel(got, want) -> float:
    """Largest |got - want| relative to the largest |want|."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def numpy_tree(x):
    """A reference pytree (params or cache) as nested dicts/lists of numpy
    arrays, its NamedTuples turned into dicts by field name."""
    if hasattr(x, "_asdict"):
        return {k: numpy_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [numpy_tree(v) for v in x]
    return np.array(x)


@functools.lru_cache(maxsize=None)
def models(name: str):
    """(reference model, its params, the port's CPU model with those
    weights) for the reduced ``name``, weights from ``PRNGKey(0)``."""
    cfg = jcfg.get(name, reduced=True)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = ttr.make_model(name, reduced=True, device="cpu")
    tm.load_state_dict(convert.model_params_from_numpy(tm.cfg, numpy_tree(params)))
    return jm, params, tm


def tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def recorded_decode(eng, to_numpy):
    """Wrap ``eng._decode`` (either engine's) to record each call's (tokens
    in, cache index, tokens out, last logits) as numpy; returns the list."""
    calls, step = [], eng._decode

    def decode(*args):
        nxt, cache, last = step(*args)
        toks, index = args[-2], args[-1]
        calls.append(tuple(to_numpy(x) for x in (toks, index, nxt, last)))
        return nxt, cache, last

    eng._decode = decode
    return calls


def serve_both(jm, params, tm, prompts, slots: int, max_new: int, max_len: int = 128):
    """The reference's engine and the port's over the same requests, every
    decode call recorded: (reference calls, port calls, reference outputs,
    port outputs)."""
    ref = JServeEngine(jm, params, slots=slots, max_len=max_len)
    port = engine.ServeEngine(tm, slots=slots, max_len=max_len)
    rcalls = recorded_decode(ref, np.asarray)
    pcalls = recorded_decode(port, lambda x: x.numpy() if torch.is_tensor(x) else np.asarray(x))
    want, got = [], []
    for eng, out in ((ref, want), (port, got)):
        for p in prompts:
            eng.submit(p, max_new=max_new)
        out.append(eng.run())
    return rcalls, pcalls, want[0], got[0]


def calls_agree(rcalls, pcalls, tie: float) -> bool:
    """Each decode call's input tokens and cache index equal, its logits
    within 1e-4 of the reference's largest |logit|, its tokens equal; a
    token may differ only where the reference's top-2 gap is within ``tie``
    of its largest |logit|, and then the runs part: False."""
    for i, ((rt, ri, rn, rl), (pt, pi, pn, pl)) in enumerate(zip(rcalls, pcalls)):
        assert np.array_equal(pt, rt) and int(pi) == int(ri), i
        assert rel(pl, rl) <= 1e-4, i
        if not np.array_equal(pn[:, 0], rn[:, 0]):
            top2 = np.sort(rl, axis=-1)[:, -2:]
            gap = (top2[:, 1] - top2[:, 0]) / np.abs(rl).max()
            bad = pn[:, 0] != rn[:, 0]
            assert np.all(gap[bad] <= tie), (i, gap[bad])
            return False
    return True
