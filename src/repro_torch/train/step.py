"""train_step factory: microbatched gradient accumulation + AdamW (port of
``repro/train/step.py``).

Microbatching bounds the backward working set: the logits-grad and
saved-activation buffers scale with the microbatch, while gradients
accumulate in ``accum_dtype`` (float32 by default). nm=1 is a plain step.

The reference's ``constrain``, ``param_specs`` and ``constrain_in_loop``
are sharding constraints for a device mesh; on one device they mean
nothing, so the port drops them (``parallel/partition.py`` computes the
specs as data, and its ``make_constrain`` is the identity on one
device).
"""
from __future__ import annotations

import torch

from repro_torch.models.init import flatten_tree, unflatten_tree
from repro_torch.models.transformer import loss_fn
from repro_torch.train.optimizer import AdamWConfig, adamw_update

TARGET_TOKENS_PER_MB_PER_DEVICE = 8192


def pick_microbatches(global_batch: int, seq: int, n_data_shards: int) -> int:
    """Smallest nm dividing the batch with per-device microbatch tokens under
    the target (keeps the backward's temporaries within device memory)."""
    per_dev_tokens = global_batch * seq // max(n_data_shards, 1)
    nm = 1
    while (
        per_dev_tokens // nm > TARGET_TOKENS_PER_MB_PER_DEVICE
        and nm < global_batch
        and global_batch % (nm * 2) == 0
    ):
        nm *= 2
    return nm


def grads_of(params, cfg, batch):
    """(loss, paths, grads) of ``loss_fn`` at ``params``, the grads in JAX's
    leaf order. Autograd runs on detached leaves, so ``params`` is never
    touched; a leaf the loss does not reach gets zeros, as JAX gives."""
    pairs = flatten_tree(params)
    live = [leaf.detach().requires_grad_(True) for _, leaf in pairs]
    with torch.enable_grad():
        loss = loss_fn(unflatten_tree([(path, leaf) for (path, _), leaf
                                       in zip(pairs, live)]), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), [path for path, _ in pairs], grads


def make_train_step(cfg, ocfg: AdamWConfig, nm: int,
                    accum_dtype: str = "float32", grads_fn=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, loss,
    metrics). With ``nm`` > 1, microbatch i is rows [i B / nm, (i + 1) B /
    nm) of every batch entry (the reference's reshape); the gradients add
    up in ``accum_dtype`` and are divided by nm in float32, and the loss is
    the microbatches' mean. ``grads_fn`` (``grads_of`` by default) takes
    ``grads_of``'s arguments and returns what it returns (the dry run
    counts a microbatch's gradient once and its repeats without running
    them)."""
    acc_dt = getattr(torch, accum_dtype)
    grads_fn = grads_fn or grads_of

    def train_step(params, opt_state, batch):
        if nm == 1:
            loss, paths, grads = grads_fn(params, cfg, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            acc, losses = None, []
            for i in range(nm):
                mb = {k: v[i * b // nm:(i + 1) * b // nm]
                      for k, v in batch.items()}
                l, paths, g = grads_fn(params, cfg, mb)
                if acc is None:
                    acc = [torch.zeros(t.shape, dtype=acc_dt,
                                       device=t.device) for t in g]
                acc = [a + t.to(acc_dt) for a, t in zip(acc, g)]
                losses.append(l)
                del g
            grads = [a.float() / nm for a in acc]
            loss = torch.stack(losses).mean()
        params, opt_state, metrics = adamw_update(
            params, unflatten_tree(list(zip(paths, grads))), opt_state, ocfg)
        return params, opt_state, loss, metrics

    return train_step
