"""Shared inputs of the serving-path parity tests (``test_torch_decode.py``,
``test_torch_serve.py``): the reference's reduced model and the port's
model with the same weights, and the comparison they use."""

import functools

import jax
import numpy as np
import torch

from repro import configs as jcfg
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.models import transformer as ttr


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
