"""Port parity: the serving engine and launcher (``repro_torch.serve``,
``repro_torch.launch.serve``) against live ``repro.serve`` /
``repro.launch.serve``.

* the block-synced decode loop equals a per-step early-exit loop token for
  token (a scripted model, as ``tests/test_system.py`` drives the
  reference's), with fewer decode calls when rows finish early;
* greedy generation on the reduced h2o-danube-3-4b: teacher-forced decode
  logits within 5 % of their largest value of the reference's (bf16
  matmuls, ``tests/test_torch_lm.py``), and the generated tokens equal the
  reference's up to the first step whose top-2 margin is inside that
  tolerance;
* ``AdmissionController`` equal to the reference's on one offer / complete
  script, every stat and return value;
* ``serve_offered_load(pace=False)`` and ``main`` on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.spec import init_params as jinit  # noqa: E402
from repro.noc.online import ArrivalProcess as JArrivalProcess  # noqa: E402
from repro.serve import AdmissionController as JAdmission  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import lm_params_from_jax  # noqa: E402
from repro_torch.serve import (AdmissionController, Engine,  # noqa: E402
                               GenerationConfig)

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

LOGIT_TOL = 0.05


class _ScriptedModel:
    """Step ``t``'s logits put all mass on ``script[:, t]``; the cache is
    the step counter."""

    vocab = 16

    def __init__(self, script):
        self.script = torch.tensor(script, dtype=torch.int32)

    def prefill(self, params, prompts, context):
        return self._logits(0), 0

    def decode_step(self, params, tok, cache, pos):
        return self._logits(cache + 1), cache + 1

    def _logits(self, step):
        b, t = self.script.shape
        idx = self.script[:, min(step, t - 1)].long()
        lg = torch.full((b, self.vocab), -1e9)
        lg[torch.arange(b), idx] = 0.0
        return lg


def _per_step_generate(engine, prompts, gen):
    """The loop with one host read of ``done`` a decode step."""
    b, s = prompts.shape
    logits, cache = engine.model.prefill(engine.params, prompts,
                                         engine.context)
    out = []
    tok = engine._sample(logits, gen, None)
    done = torch.zeros((b,), dtype=torch.bool)
    for i in range(gen.max_new_tokens):
        out.append(tok)
        done = done | (tok == gen.eos_id)
        if bool(done.all()):
            break
        pos = torch.full((b,), s + i, dtype=torch.int32)
        logits, cache = engine._decode(engine.params, tok, cache, pos)
        tok = torch.where(done, gen.eos_id, engine._sample(logits, gen, None))
    return torch.stack(out, dim=1)


def test_engine_block_sync_matches_per_step_loop():
    eos = 7
    script = [[4, 2, eos, 1, 1, 1, 1, 1, 1, 1, 1, 1],
              [5, 3, 6, 2, eos, 1, 1, 1, 1, 1, 1, 1]]
    prompts = torch.zeros((2, 3), dtype=torch.int32)
    gen = GenerationConfig(max_new_tokens=12, eos_id=eos, sync_every=4)
    engine = Engine(_ScriptedModel(script), params={}, context=32)
    inner = engine._decode
    ref = _per_step_generate(engine, prompts, gen)
    assert ref.shape == (2, 5)
    calls = []
    engine._decode = lambda *a: calls.append(0) or inner(*a)
    out = engine.generate(prompts, gen)
    assert out.dtype == torch.int32
    assert torch.equal(out, ref)
    assert len(calls) < gen.max_new_tokens - 1
    # the reference's engine on the same script gives the same tokens
    jengine = JEngine(_JaxScripted(script), params={}, context=32)
    want = jengine.generate(jnp.zeros((2, 3), jnp.int32),
                            JGen(max_new_tokens=12, eos_id=eos, sync_every=4))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    full = GenerationConfig(max_new_tokens=12, eos_id=-1, sync_every=4)
    out_full = engine.generate(prompts, full)
    assert out_full.shape == (2, 12)
    assert torch.equal(out_full, _per_step_generate(engine, prompts, full))


class _JaxScripted:
    vocab = 16

    def __init__(self, script):
        self.script = jnp.asarray(script, jnp.int32)

    def prefill(self, params, prompts, context):
        return self._logits(jnp.int32(0)), jnp.int32(0)

    def decode_step(self, params, tok, cache, pos):
        return self._logits(cache + 1), cache + 1

    def _logits(self, step):
        b, t = self.script.shape
        idx = self.script[:, jnp.minimum(step, t - 1)]
        lg = jnp.full((b, self.vocab), -1e9, jnp.float32)
        return lg.at[jnp.arange(b), idx].set(0.0)


@pytest.fixture(scope="module")
def danube():
    jm = jconfigs.get("h2o-danube-3-4b").build_reduced()
    jp = jinit(jm.specs(), jax.random.PRNGKey(0))
    m = configs.get("h2o-danube-3-4b").build_reduced()
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(5).integers(0, m.cfg.vocab, (3, 10))
    return jm, jp, m, p, prompts.astype(np.int32)


def test_greedy_generation_equals_reference(danube):
    """20 new tokens from a 10-token prompt (the SWA ring of 16 wraps)."""
    jm, jp, m, p, prompts = danube
    n, vocab = 20, m.cfg.vocab
    want = np.array(JEngine(jm, jp, context=64).generate(
        jnp.asarray(prompts), JGen(max_new_tokens=n)))
    got = Engine(m, p, context=64).generate(torch.from_numpy(prompts),
                                            GenerationConfig(max_new_tokens=n))
    assert got.shape == want.shape == (3, n)
    # the reference's logits along its own tokens, and the port's
    jlg, jc = jm.prefill(jp, jnp.asarray(prompts), 64)
    lg, c = m.prefill(p, torch.from_numpy(prompts), 64)
    jdec = jax.jit(jm.decode_step)
    first_tight = np.full(3, n)
    for i in range(n):
        jl = np.asarray(jlg)[:, :vocab]
        scale = float(np.abs(jl).max())
        np.testing.assert_allclose(lg.numpy()[:, :vocab], jl, rtol=0,
                                   atol=LOGIT_TOL * scale)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        tight = (top2[:, 1] - top2[:, 0]) <= 2 * LOGIT_TOL * scale
        first_tight = np.where(tight & (first_tight == n), i, first_tight)
        if i == n - 1:
            break
        pos = np.full(3, 10 + i, np.int32)
        jlg, jc = jdec(jp, jnp.asarray(want[:, i]), jc, jnp.asarray(pos))
        lg, c = m.decode_step(p, torch.from_numpy(want[:, i]), c,
                              torch.from_numpy(pos))
    assert first_tight.max() > 0
    for r in range(3):
        k = int(first_tight[r])
        np.testing.assert_array_equal(got.numpy()[r, :k], want[r, :k])


def test_temperature_sampling_from_a_generator(danube):
    _, _, m, p, prompts = danube
    engine = Engine(m, p, context=32)
    gen = GenerationConfig(max_new_tokens=6, temperature=1.0)
    draws = [engine.generate(torch.from_numpy(prompts), gen,
                             generator=torch.Generator().manual_seed(s))
             for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert all(int(d.max()) < m.cfg.vocab for d in draws)


def test_admission_controller_equals_reference():
    script = [("offer", 0, 0.0), ("offer", 1, 5.0), ("offer", 2, 6.0),
              ("complete", 0, 30.0, False), ("offer", 3, 31.0),
              ("complete", 1, 40.0, True), ("offer", 4, 41.0),
              ("offer", 5, 42.0), ("complete", 3, 90.0, False),
              ("complete", 4, 200.0, False)]
    for depth, deadline in ((2, 50.0), (None, None), (1, 100.0)):
        a = AdmissionController(max_queue_depth=depth, deadline=deadline)
        j = JAdmission(max_queue_depth=depth, deadline=deadline)
        for op in script:
            if op[0] == "offer":
                assert a.offer(op[1], op[2]) == j.offer(op[1], op[2])
            elif op[1] in j._outstanding:
                assert (a.complete(op[1], op[2], failed=op[3])
                        == j.complete(op[1], op[2], failed=op[3]))
            assert a.queue_depth == j.queue_depth
        assert a.stats() == j.stats()
    for bad in (dict(max_queue_depth=0), dict(deadline=0.0)):
        with pytest.raises(ValueError):
            AdmissionController(**bad)
    a = AdmissionController()
    a.offer("r", 0.0)
    with pytest.raises(ValueError, match="already outstanding"):
        a.offer("r", 1.0)


def test_serve_offered_load_replays_arrivals():
    engine = Engine(_ScriptedModel([[4, 2, 3, 1]]), params={}, context=32)
    prompts = torch.zeros((6, 3), dtype=torch.int32)
    gen = GenerationConfig(max_new_tokens=4)
    outs, stats = launch.serve_offered_load(
        engine, prompts, gen, load=200.0, arrival="poisson", seed=3,
        pace=False)
    assert len(outs) == 6 and all(o.shape == (1, 4) for o in outs)
    assert stats["count"] == 6 and stats["truncated"] == 0
    assert stats["p99"] >= stats["p50"] is not None
    assert stats["throughput_rps"] > 0
    assert (stats["offered_load"], stats["arrival"]) == (200.0, "poisson")
    np.testing.assert_array_equal(
        launch.ArrivalProcess("poisson", 200.0, 3).times(6),
        JArrivalProcess("poisson", 200.0, 3).times(6))


def test_main_on_the_cpu(capsys):
    out = launch.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                       "--context", "16"])
    assert out.shape == (2, 4)
    outs, stats = launch.main([
        "--arch", "h2o-danube-3-4b", "--reduced", "--device", "cpu",
        "--offered-load", "50", "--num-requests", "3", "--arrival",
        "poisson", "--prompt-len", "6", "--max-new", "3", "--context", "16"])
    assert len(outs) == 3 and stats["count"] == 3
    text = capsys.readouterr().out
    assert "generated (2, 4) tokens" in text and "served 3 requests" in text
    for arch in ("whisper-medium", "internvl2-1b"):
        with pytest.raises(SystemExit):
            launch.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_serving_defaults_to_the_card():
    """With no device named, the launcher and a fresh LM cache want CUDA,
    and say how to ask for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so cuda is the default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "xlstm-125m", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.get("xlstm-125m").build_reduced().init_cache(1, 8)
