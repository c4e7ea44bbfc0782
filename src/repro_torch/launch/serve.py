"""Serving launcher: batched greedy decode through ``ServeEngine`` with the
UpLIF prefix-cache index (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b --requests 8
      [--prompt-len 32] [--new-tokens 16] [--device cuda|cpu]

The requests are the reference's: each prompt is a shared half from
``default_rng(0)`` and a half of its own, so every request after the first
hits the prefix index (whose lookups are K1 and K2 on the card). As in the
reference, the command line serves the reduced (smoke) config; any config
serves through ``serve(cfg, ...)``. ``--device`` is the port's (``cuda``
by default, raising without a card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def make_requests(cfg, requests: int, prompt_len: int, new_tokens: int):
    """The reference's requests: a shared first half from
    ``default_rng(0)``, then each request's own half."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, prompt_len // 2).astype(np.int32)
    return [
        Request(i, np.concatenate([
            shared,
            rng.integers(0, cfg.vocab, prompt_len // 2).astype(np.int32),
        ]), new_tokens)
        for i in range(requests)
    ]


def serve(cfg, *, requests: int = 6, prompt_len: int = 32,
          new_tokens: int = 16, device=None, seed: int = 0,
          params=None) -> dict:
    """Serve ``make_requests``' wave with ``cfg`` on ``device`` (``cuda``
    unless the caller passes another): the weights are ``params`` (a
    stored parameter tree) or ``init_params(cfg, seed)``. Returns the
    served requests (``done``, each with its ``out`` tokens), the
    seconds, tokens and tokens/s, the prefix index's hits and misses and
    its bytes. The engine is closed before it returns."""
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed, device=device)
    eng = ServeEngine(cfg, params, max_len=prompt_len + new_tokens + 8,
                      device=device)
    try:
        reqs = make_requests(cfg, requests, prompt_len, new_tokens)
        t0 = time.perf_counter()
        done = eng.generate(reqs)
        dt = time.perf_counter() - t0
        index = eng.prefix_index
        toks = sum(len(r.out) for r in done)
        return {"done": done, "seconds": dt, "tokens": toks,
                "tokens_per_s": toks / dt, "hits": index.hits,
                "misses": index.misses, "index_bytes": index.memory_bytes()}
    finally:
        eng.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import smoke_config

    cfg = smoke_config(args.arch)
    res = serve(cfg, requests=args.requests, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, device=args.device)
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if torch.device(args.device).type == "cuda" else "cpu")
    print(f"{len(res['done'])} requests, {res['tokens']} tokens in "
          f"{res['seconds']:.2f}s ({res['tokens_per_s']:.1f} tok/s {where})")
    print(f"prefix cache: hits={res['hits']} misses={res['misses']} "
          f"index={res['index_bytes']/2**10:.1f} KiB")
    return res


if __name__ == "__main__":
    main()
