"""Serving launcher: cached decode of batched requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced --batch 4 --prompt-len 16 --gen 24 --device cpu

``--reduced`` serves the smoke-scale config with real batched requests on
``--device`` (default ``cuda``).  Without it the full config's serve step
is dry-run against the production mesh (``launch.dryrun.run_one`` at
``--shape``, decode_32k by default: shapes and counts on the ``meta``
device, nothing allocated) and its record written.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.launch import steps
from repro_torch.models import multimodal, transformer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(serve_step, model, prompt: dict, gen: int, *, keep_logits: bool = False) -> dict:
    """Step the prompt, ``tokens`` (B, P) or, for audio, ``codes`` (B, P, K),
    through a fresh cache one position at a time, then decode ``gen``
    greedy positions (argmax per codebook for audio, fed back as (B, 1, K)).
    Returns ``tokens`` (B, gen) or (B, gen, K), ``prompt_s`` and ``gen_s``
    (host seconds, each ending in a device synchronise), and with
    ``keep_logits`` the float32 logits at every prompt position,
    ``prompt_logits`` (B, P, V) or (B, P, K, V)."""
    key = "codes" if "codes" in prompt else "tokens"
    toks = prompt[key].to(model.device)
    b, plen = toks.shape[:2]
    caches = model.init_caches(b, plen + gen)
    logits, kept = None, []
    _sync(model.device)
    t0 = time.perf_counter()
    for t in range(plen):
        logits, caches = serve_step({key: toks[:, t:t + 1]}, caches, t)
        if keep_logits:
            kept.append(logits[:, 0].to(torch.float32))
    _sync(model.device)
    t1 = time.perf_counter()
    out = []
    for t in range(plen, plen + gen):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]            # (B, 1) or (B, 1, K)
        logits, caches = serve_step({key: nxt}, caches, t)
        out.append(nxt)
    _sync(model.device)
    t2 = time.perf_counter()
    return {"tokens": torch.cat(out, dim=1) if out else toks[:, :0],
            "prompt_s": t1 - t0, "gen_s": t2 - t1,
            "prompt_logits": torch.stack(kept, dim=1) if keep_logits else None}


def run_reduced(arch: str, batch: int, prompt_len: int, gen: int, *, device="cuda",
                params: dict | None = None) -> torch.Tensor:
    """Serve the reduced ``arch``: ``batch`` requests whose prompt repeats
    one seeded token (a frame of K codes for audio) ``prompt_len`` times,
    each decoding ``gen`` greedy positions.  ``params`` (the reference's
    pytree as numpy) replaces the seeded init.  Returns the generated
    tokens, (batch, gen) or (batch, gen, K)."""
    cfg = cfg_base.get(arch).reduced()
    serve_step, model = steps.make_serve_step(cfg, device=device)
    if params is not None:
        model.load_state_dict(transformer.params_from_numpy(cfg, params, model.device))
    print(f"[serve] {arch} (reduced): batch {batch}, prompt {prompt_len}, "
          f"generating {gen} tokens/request")
    prompt = {k: v.repeat(1, prompt_len, *[1] * (v.dim() - 2))
              for k, v in multimodal.decode_batch_for(cfg, batch).items()}
    res = generate(serve_step, model, prompt, gen)
    dt = res["prompt_s"] + res["gen_s"]
    total = batch * (prompt_len + gen)
    first = res["tokens"][0, :8]
    label = "sample continuation" + (" (codebook 0)" if cfg.n_codebooks else "")
    print(f"[serve] {total} cached decode steps in {dt:.1f}s "
          f"({total / dt:,.0f} tok/s incl. prefill) on {model.device}; "
          f"{label}: {(first[:, 0] if cfg.n_codebooks else first).tolist()}")
    return res["tokens"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    if args.reduced:
        return run_reduced(args.arch, args.batch, args.prompt_len, args.gen, device=args.device)
    print("[serve] full config -> dry-run of serve_step against the production mesh "
          "(meta device)")
    from repro_torch.launch import dryrun
    return dryrun.run_one(args.arch, args.shape, multi_pod=args.multi_pod)


if __name__ == "__main__":
    main()
