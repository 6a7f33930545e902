"""PyTorch port vs JAX reference: the continuous-batching serve engine and
its launcher, on the CPU at the reduced configurations.

The port's ``ServeEngine`` keeps the reference's semantics, quirks
included (a slot's prefill writes token 0 into every other slot's cache
row and advances their SSM states; a step decodes every slot at
``positions.max()``), so its tokens are the reference's.  Every decode
call of both engines is recorded: its input tokens and cache index are
equal, its logits within 1e-4 of the reference's largest |logit|, and its
output tokens equal; a token may differ only where the reference's top-2
gap is within 1e-4 of its largest |logit| (a tie), after which the runs
part and are compared no further.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # test workers share the cores; small ops run serially
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from _torch_cases import engine_fed_stream  # noqa: E402
from _torch_serve_cases import calls_agree, models, rel, serve_both, tokens  # noqa: E402

TIE = 1e-4


def _serve(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    return eng.run()


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "gemma2-9b", "mamba2-780m"])
def test_engine_tokens_match_reference(name):
    jm, params, tm = models(name)
    prompts = [tokens(tm.cfg.vocab, 12, seed=20 + i) for i in range(3)]
    rcalls, pcalls, want, got = serve_both(jm, params, tm, prompts, slots=2, max_new=8)
    assert len(pcalls) == len(rcalls) == 3 * 12 + 2 * 8
    if not calls_agree(rcalls, pcalls, TIE):
        return                                        # parted at a tie
    assert sorted(got) == sorted(want) == [1, 2, 3]
    assert all(got[u] == want[u] and len(got[u]) == 8 for u in want)


@pytest.mark.parametrize("name", ["gemma2-9b", "mamba2-780m"])
def test_one_slot_engine_equals_cache_less_forward(name):
    """With one slot the engine's cache holds one sequence, the requests
    one after another: each generated token is the argmax of the
    cache-less forward over the tokens fed before it.  Four requests feed
    80 tokens, past gemma2's reduced local window of 64."""
    _, _, tm = models(name)
    prompts = [tokens(tm.cfg.vocab, 12, seed=30 + i) for i in range(4)]
    done = _serve(engine.ServeEngine(tm, slots=1, max_len=128), prompts, 8)
    outs = [done[u] for u in sorted(done)]
    stream = engine_fed_stream(prompts, outs)
    assert len(stream) == 80 > (tm.cfg.window or 0)
    logits = tm.apply({"tokens": torch.tensor([stream])})[0]
    fed_at = [r * 20 + 12 + j for r in range(4) for j in range(8)]
    want = logits[fed_at].argmax(-1).tolist()
    assert [x for out in outs for x in out] == want


def test_prefill_and_sampling_steps():
    """``make_prefill_step`` is ``Model.apply`` from cache row 0; sampling
    draws with the generator it is given, and refuses to run without one."""
    _, _, tm = models("tinyllama-1.1b")
    toks = torch.from_numpy(tokens(tm.cfg.vocab, (2, 16), seed=40))
    logits, cache = serve.make_prefill_step(tm)(tm.init_cache(2, 32, torch.float32),
                                                {"tokens": toks})
    assert torch.equal(logits, tm.apply({"tokens": toks}, cache=tm.init_cache(
        2, 32, torch.float32), cache_index=0)[0])
    assert rel(logits.numpy(), tm.apply({"tokens": toks}).numpy()) <= 1e-5
    step = serve.make_serve_step(tm, greedy=False, temperature=0.7)
    nxt = toks[:, -1:]
    draws = [step([tuple(x.clone() for x in c) for c in cache], nxt, 16,
                  torch.Generator().manual_seed(3))[0] for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (2, 1)
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < tm.cfg.vocab
    with pytest.raises(ValueError, match="torch.Generator"):
        step(cache, nxt, 16)
    assert serve.Request.__module__ == "repro_torch.serve.engine"


def test_launcher_on_cpu(capsys):
    assert launch_serve.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 8/8 requests, 128 tokens") and "on CPU" in out[0]
    assert len(out) == 9


def test_launcher_refuses_a_silent_cpu_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch_serve.main([]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "CUDA is not available" in cap.err
