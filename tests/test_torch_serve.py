"""``repro_torch.launch.serve`` against the JAX package's: the same greedy
tokens from the same weights (``interop.lm_params_from_numpy``) and prompts
for reduced smollm, granite (MoE), hymba (attention + SSM, decode past its
sliding window) and xlstm in float32.  Logits of the two packages differ
by roundings (``tests/test_torch_models.py``), so the test replays every
step in both packages and asserts that each step's top-2 logit margin is
more than twice the largest logit difference: no rounding could have
flipped an argmax, and token equality is not luck.  Plus the spans,
metrics and event, the MoE prompt rule and the CLI on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _replay(params, cfg, prompts, tokens):
    """Logits (B, steps, V) of every generated step: the port's prefill
    and teacher-forced decode."""
    B, PL = prompts.shape
    out = []
    with torch.no_grad():
        lg, caches = lm.prefill_step(params, {"tokens": prompts}, cfg,
                                     PL + tokens.shape[1])
        for i in range(tokens.shape[1]):
            out.append(lg[:, -1])
            if i + 1 < tokens.shape[1]:
                lg, caches = lm.decode_step(params, caches, {
                    "tokens": tokens[:, i:i + 1],
                    "positions": torch.full((B, 1), PL + i,
                                            dtype=torch.int32)}, cfg)
    return torch.stack(out, dim=1).numpy()


def _ref_replay(params, cfg, prompts, tokens):
    B, PL = prompts.shape
    prefill = jax.jit(lambda p, b: ref_lm.prefill_step(
        p, b, cfg, PL + tokens.shape[1]))
    decode = jax.jit(lambda p, c, b: ref_lm.decode_step(p, c, b, cfg))
    lg, caches = prefill(params, {"tokens": jnp.asarray(prompts)})
    out = []
    for i in range(tokens.shape[1]):
        out.append(np.asarray(lg[:, -1]))
        if i + 1 < tokens.shape[1]:
            lg, caches = decode(params, caches, {
                "tokens": jnp.asarray(tokens[:, i:i + 1]),
                "positions": jnp.full((B, 1), PL + i, jnp.int32)})
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch,prompt_len", [
    ("smollm-135m", 12), ("granite-moe-3b-a800m", 12), ("hymba-1.5b", 24),
    ("xlstm-350m", 12)])
def test_generate_gives_the_reference_tokens(arch, prompt_len):
    rcfg = ref_configs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    rp = ref_lm.init_params(jax.random.PRNGKey(11), rcfg)
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, cfg.vocab, (2, prompt_len)).astype(np.int32)
    gen = 12                     # hymba: 24 + 12 > its window of 32
    want = np.asarray(ref_serve.generate(rp, rcfg, jnp.asarray(prompts),
                                         max_seq=prompt_len + gen,
                                         gen_steps=gen))
    p = torch.from_numpy(prompts)
    got, _, logits = serve.generate_with_stats(
        pp, cfg, p, max_seq=prompt_len + gen, gen_steps=gen,
        return_logits=True)
    assert got.dtype == torch.int32 and got.shape == (2, gen)
    assert np.array_equal(got.numpy(), want)
    mine = _replay(pp, cfg, p, got)
    assert np.array_equal(logits.numpy(), mine)
    diff = np.abs(mine - _ref_replay(rp, rcfg, prompts, want)).max()
    top2 = np.sort(mine, axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).min()
    assert margin > 2 * diff, (margin, diff)
    assert np.array_equal(mine.argmax(-1), got.numpy())


def test_spans_metrics_and_event():
    cfg = configs.get_config("smollm-135m").reduced()
    params = lm.init_params(0, cfg, device="cpu")
    prompts = torch.zeros((3, 5), dtype=torch.int32)
    before = metrics.counter("serve_tokens_total").value
    trace.configure()
    try:
        toks, stats = serve.generate_with_stats(params, cfg, prompts,
                                                max_seq=9, gen_steps=4)
        recs = trace.events()
    finally:
        trace.disable()
    assert toks.shape == (3, 4)
    assert metrics.counter("serve_tokens_total").value - before == 3 * 4
    assert metrics.gauge("serve_ttft_seconds").value == stats["ttft_s"] > 0
    assert metrics.gauge("serve_decode_tok_per_s").value == \
        stats["decode_tok_per_s"] > 0
    assert metrics.histogram("serve_ttft_seconds_hist").count >= 1
    spans = {r["name"]: r for r in recs if r["kind"] == "span"}
    assert spans["serve.prefill"]["attrs"] == {"batch": 3, "prompt_len": 5}
    assert spans["serve.decode"]["attrs"] == {"batch": 3, "steps": 3}
    (req,) = [r for r in recs if r["name"] == "serve.request"]
    assert req["attrs"]["batch"] == 3 and req["attrs"]["gen_steps"] == 4


def test_moe_prompt_must_split_into_dispatch_groups():
    import dataclasses

    cfg = dataclasses.replace(
        configs.get_config("granite-moe-3b-a800m").reduced(), moe_group=8)
    params = lm.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of min"):
        serve.generate(params, cfg, torch.zeros((1, 12), dtype=torch.int32),
                       max_seq=16, gen_steps=2)
    with pytest.raises(ValueError, match="multiple of it"):
        serve.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                    "--prompt-len", "1536", "--device", "cpu"])
    toks = serve.generate(params, cfg, torch.zeros((1, 16),
                                                   dtype=torch.int32),
                          max_seq=18, gen_steps=2)
    assert toks.shape == (1, 2)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=120)


def test_cli_serves_on_the_cpu_when_asked():
    out = _cli("--arch", "xlstm-350m", "--reduced", "--batch", "2",
               "--prompt-len", "8", "--gen", "4", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "generated (2, 4) tokens" in out.stdout and "TTFT" in out.stdout
    stub = _cli("--arch", "musicgen-medium", "--reduced", "--device", "cpu")
    assert stub.returncode != 0
    assert "token-frontend" in stub.stderr


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "smollm-135m", "--reduced"])
