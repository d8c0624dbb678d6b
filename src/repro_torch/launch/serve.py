"""Batched greedy serving: prefill, then one decode step per token.

CLI (CPU demo; drop ``--device`` on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --batch 4 --prompt-len 16 --gen 16 --device cpu \\
      [--data D --model M]

On a mesh (:mod:`repro_torch.launch.mesh`; the CLI's ``--data --model``
under a rank launcher) the batch splits over the data axes, the weights
and caches over the model axis (:func:`repro_torch.launch.shardings.
shard_params`), and each next token is the argmax over the vocabulary
shards (:func:`repro_torch.models.tp.vocab_argmax`: the first maximal
index, as at model size 1).

Decode is deterministic per (params, prompt, positions) by construction:
greedy argmax (the first maximal index, as ``jnp.argmax``), fixed-shape
steps, and the MoE router's top-k ties broken to the lower expert index.
Everything runs eagerly under ``torch.inference_mode()``: the prefill fills
the per-unit caches (KV ring buffers, SSM and xLSTM states), each decode
step appends one token.

An MoE prefill dispatches each sequence in groups of
``min(cfg.moe_group, prompt_len)`` tokens that never cross sequences, so a
prompt longer than ``moe_group`` must be a multiple of it.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as registry
from repro_torch.device import resolve_device
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import add_mesh_flags, mesh_from_flags
from repro_torch.models import lm
from repro_torch.core import collectives
from repro_torch.models import tp as tp_mod
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["generate_with_stats", "generate", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_prompt(cfg: ModelConfig, prompt_len: int) -> None:
    if cfg.moe is not None and prompt_len % min(cfg.moe_group, prompt_len):
        raise ValueError(
            f"{cfg.name}: an MoE prefill of {prompt_len} tokens does not "
            f"split into dispatch groups of {cfg.moe_group} (a prompt "
            f"longer than moe_group must be a multiple of it: S % "
            f"min(moe_group, S) == 0)")


def _argmax(logits: torch.Tensor, tp) -> torch.Tensor:
    return tp_mod.vocab_argmax(logits[:, -1], tp).to(torch.int32)[:, None]


def generate_with_stats(params, cfg: ModelConfig, prompts: torch.Tensor,
                        max_seq: int, gen_steps: int,
                        return_logits: bool = False,
                        mesh: Optional[Mesh] = None):
    """Greedy generation for a fixed batch of token prompts (B, P) on
    ``prompts``' device.

    With ``mesh``, ``params`` is this rank's model shard and the rank
    serves its data rank's share of the prompts (``B`` must divide over
    the data axes); tokens, logits and ``batch`` are that share's.

    Returns ``(tokens (B, gen_steps) int32, stats)``, and with
    ``return_logits`` also the float32 logits each token was picked from
    (B, gen_steps, vocab; gathered whole over the model axis).  ``stats``
    carries
    TTFT (prompt in to first token out: the prefill and the first argmax,
    read after a synchronize on the card) and the decode rate over the
    remaining steps, timed the same way.  Both are also published to
    :mod:`repro_torch.obs.metrics` (``serve_ttft_seconds``,
    ``serve_decode_tok_per_s``, ``serve_ttft_seconds_hist``,
    ``serve_tokens_total``), under the spans ``serve.prefill`` and
    ``serve.decode`` and the event ``serve.request``.
    """
    tp = None
    if mesh is not None:
        tp = mesh.tp
        if prompts.shape[0] % mesh.size:
            raise ValueError(f"a batch of {prompts.shape[0]} does not split "
                             f"over {mesh.size} data ranks")
        per = prompts.shape[0] // mesh.size
        prompts = prompts[mesh.rank * per:(mesh.rank + 1) * per]
    vocab_tp = tp_mod.split(tp, lm.head_table(params, cfg).shape[0],
                            cfg.vocab)

    def whole(lg):
        return collectives.model_all_gather(lg[:, -1], vocab_tp, dim=-1)

    B, PL = prompts.shape
    dev = prompts.device
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        with obs_trace.span("serve.prefill", batch=int(B),
                            prompt_len=int(PL)):
            logits, caches = lm.prefill_step(params, {"tokens": prompts},
                                             cfg, max_seq, tp)
            tok = _argmax(logits, vocab_tp)
            _sync(dev)
        ttft = time.perf_counter() - t0
        out = [tok]
        seen = [whole(logits)] if return_logits else None

        t1 = time.perf_counter()
        with obs_trace.span("serve.decode", batch=int(B),
                            steps=int(gen_steps - 1)):
            for i in range(gen_steps - 1):
                pos = torch.full((B, 1), PL + i, dtype=torch.int32,
                                 device=dev)
                lg, caches = lm.decode_step(
                    params, caches, {"tokens": tok, "positions": pos}, cfg,
                    tp)
                tok = _argmax(lg, vocab_tp)
                out.append(tok)
                if seen is not None:
                    seen.append(whole(lg))
            _sync(dev)
        decode_s = time.perf_counter() - t1
        tokens = torch.cat(out, dim=1)
        step_logits = torch.stack(seen, dim=1) if seen is not None else None
    decode_toks = B * max(gen_steps - 1, 0)
    stats = {"ttft_s": ttft, "decode_s": decode_s,
             "decode_tok_per_s": decode_toks / decode_s if decode_s else 0.0,
             "batch": int(B), "gen_steps": int(gen_steps)}
    obs_metrics.gauge("serve_ttft_seconds").set(ttft)
    obs_metrics.gauge("serve_decode_tok_per_s").set(
        stats["decode_tok_per_s"])
    obs_metrics.histogram("serve_ttft_seconds_hist").observe(ttft)
    obs_metrics.counter("serve_tokens_total").inc(B * gen_steps)
    obs_trace.event("serve.request", **stats)
    if return_logits:
        return tokens, stats, step_logits
    return tokens, stats


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, max_seq: int,
             gen_steps: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Greedy generation; see :func:`generate_with_stats`."""
    return generate_with_stats(params, cfg, prompts, max_seq, gen_steps,
                               mesh=mesh)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Greedy generation from random weights of one arch.")
    ap.add_argument("--arch", required=True,
                    help="one of " + ", ".join(registry.list_archs()))
    ap.add_argument("--reduced", action="store_true",
                    help="the config's small same-family variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    add_mesh_flags(ap, pod=False)
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.embed_frontend == "stub":
        raise SystemExit("serve CLI demo supports token-frontend archs")
    _check_prompt(cfg, args.prompt_len)
    dev = resolve_device(args.device)
    mesh = mesh_from_flags(args, dev)
    params = sh.shard_params(lm.init_params(args.seed, cfg, dev), mesh, cfg)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)).to(dev)
    t0 = time.time()
    toks, stats = generate_with_stats(params, cfg, prompts,
                                      max_seq=args.prompt_len + args.gen,
                                      gen_steps=args.gen, mesh=mesh)
    dt = time.time() - t0
    print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({toks.numel() / dt:.1f} tok/s) on {dev}, mesh {mesh.shape}")
    print(f"TTFT {stats['ttft_s'] * 1e3:.1f}ms (prefill) | decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s over "
          f"{stats['gen_steps'] - 1} steps x batch {stats['batch']}")
    print(toks[0].cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
