"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--steps N]
      [--batch B] [--seq S] [--strategy tp_fsdp] [--ckpt-dir DIR]
      [--device cuda|cpu]

The reference's path on one device: the mesh of the devices it runs on
(one), the ``ShardingStrategy`` whose shardings place the parameters
(``NamedSharding.place``: on a mesh of one device, the identity), the
``PackedCorpus`` whose document index serves every batch (K1 and K2 on the
card), ``make_train_step`` and the fault-tolerant ``loop.run`` with a
checkpoint every 25 steps and at the end, written asynchronously. The loop
resumes from the newest checkpoint under ``--ckpt-dir``, which defaults to
``repro_torch_launch_train`` in the temp directory (not the reference's
``/tmp/repro_launch_train``, which the JAX package's launcher fills).

As in the reference, ``--smoke`` is a ``store_true`` flag that defaults to
True, so the command line always trains the reduced config; a full config
reaches the trainer only through ``train(cfg, ...)``. ``--device`` is the
port's (``cuda`` by default, raising without a card).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_launch_train")


def train(cfg, *, steps: int, batch: int, seq: int,
          strategy: str = "tp_fsdp", ckpt_dir: str = DEFAULT_CKPT_DIR,
          device=None, lr: float = 1e-3, n_docs: int = 2048,
          wrap_step=None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens from
    the corpus, on ``device`` (``cuda`` unless the caller passes another).
    ``wrap_step``, where given, takes the train step and returns the one
    the loop calls, with the same arguments and results (a caller's
    per-step timing or counters). Returns ``loop.run``'s summary (``final_loss``, ``losses``,
    ``median_step_s``, ``step_s``, the final ``params`` and
    ``opt_state``) with the ``mesh`` and the ``corpus``."""
    from repro_torch.data.pipeline import PackedCorpus, PipelineConfig
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models import init_params
    from repro_torch.parallel.partition import ShardingStrategy, place_tree
    from repro_torch.train.loop import LoopConfig, run as run_loop
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    device = resolve_device(device)
    mesh = make_mesh_for_devices(1, model_parallel=1)  # the one device
    strat = ShardingStrategy(cfg, mesh, strategy=strategy, batch_size=batch)
    shardings = strat.param_shardings()
    corpus = PackedCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, n_docs=n_docs),
        device=device)
    # the loop holds the only reference to the initial state, so each step
    # frees the state before it (as the reference's jit donates it)
    state = [place_tree(init_params(cfg, 0, device=device), shardings)]
    state.append(init_opt_state(state[0]))
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr, total_steps=steps),
                              nm=1)
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)

    def next_batch(step):
        return {"tokens": torch.as_tensor(corpus.batch(step)["tokens"],
                                          device=device)}

    res = run_loop(
        step_fn, state.pop(0), state.pop(0), next_batch,
        LoopConfig(total_steps=steps, ckpt_every=25, ckpt_dir=ckpt_dir,
                   async_ckpt=True),
        metadata={"arch": cfg.name, "strategy": strategy},
    )
    return {**res, "mesh": mesh, "corpus": corpus}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--strategy", default="tp_fsdp")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (always on, as in the "
                         "reference; full configs through train())")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_config

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                strategy=args.strategy, ckpt_dir=args.ckpt_dir,
                device=args.device)
    n_dev = res["mesh"].size
    print(f"final loss {res['final_loss']:.4f} "
          f"({res['median_step_s']*1e3:.0f} ms/step on {n_dev} device(s), "
          f"{args.device})")
    return res


if __name__ == "__main__":
    main()
